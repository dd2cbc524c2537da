"""Build and load the port's CUDA kernels.

Each ``fourk_nerf_torch/csrc/<name>.cu`` has a plain C interface and is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``. No PyTorch header is
included, so a build takes seconds, not minutes. The library's file name
carries a hash of its source and flags, so an edited source is rebuilt.

Nothing is built when the module is imported: the first :func:`load` of a
kernel builds it, and :func:`build_all` builds every source at once, one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
KERNELS = ("sweep", "rdb")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine that has the card")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{h[:16]}.so")


def build_all(names=KERNELS) -> dict:
    """Build every named kernel that is not built yet, one nvcc each, all
    started together; waits for all of them, then raises on any failure.
    Returns {name: (seconds, compiler log)}; a kernel already built
    reports 0 s and an empty log."""
    t0 = time.perf_counter()
    jobs, done, failed = {}, {}, []
    for n in names:
        out = _lib_path(n)
        if os.path.exists(out):
            done[n] = (0.0, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        jobs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, out)
    for n, (proc, tmp, out) in jobs.items():
        text = proc.communicate()[0]
        done[n] = (time.perf_counter() - t0, text)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc failed for {n}.cu:\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, strerror: str, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function;
    ``strerror`` names the library's ``cudaGetErrorString`` wrapper."""
    if err != 0:
        fn = getattr(lib, strerror)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} at launch: "
                           f"{fn(err).decode()}")
