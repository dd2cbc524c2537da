#!/usr/bin/env python3
"""Time builds of the plane-sweep kernel against each other on the 4K frame.

Each argument names one build, ``LABEL=SOURCE.cu`` or
``LABEL=SOURCE.cu@WRAPPER.py``: the source is compiled with the port's
nvcc flags (``ops/_build.py``; its own directory first on the include path,
then ``fourk_nerf_torch/csrc``), and launched through the ``sweep`` function
of the wrapper module (by default ``ops/cuda_sweep.py``, whose C interface
the tree's ``csrc/sweep.cu`` has); a bare ``LABEL`` is the tree's kernel.
Every build is held against the plain version (``plane_sweep.sweep_plain``)
on the synthetic and the trained-anchor 4K frames of ``chip_smoke.py``
(1008x756 rays, the fern geometry, in the frame driver's tile order, or
row-major with ``--row-major``; the bf16 grid of the main path, or the
float32 grid with ``--f32``), then timed in turns, A B ... B A, by
CUDA events (mean of 3 launches after a warm-up), so that every build gets
two readings in one process on one card. The ptxas register and spill lines
of each build are printed. Run on a machine with the card, from the
repository root, for example:

    python3 -m fourk_nerf_torch.tools.sweep_variants tree \\
        slow=build/variants/slow.cu

The last line is a JSON object {scene: {label: [ms, ms]}}.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from fourk_nerf_torch import weights
from fourk_nerf_torch.ops import _build, cuda_sweep, plane_sweep

ROOT = os.path.dirname(os.path.dirname(_build.CSRC))


def _wrapper(path: str | None):
    if path is None:
        return cuda_sweep
    spec = importlib.util.spec_from_file_location(
        f"sweep_wrapper_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(specs, out_dir: str) -> dict:
    """{label: CDLL}, one nvcc per source, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc, procs, libs = _build.nvcc_path(), {}, {}
    t0 = time.perf_counter()
    for label, src, _ in specs:
        out = os.path.join(out_dir, f"libsweep_{label}.so")
        cmd = [nvcc, *_build.FLAGS, "-I", _build.CSRC, "-o", out, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        out)
    for label, (proc, out) in procs.items():
        text = proc.communicate()[0]
        print(f"{label}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in text.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print("   ", line.strip()[:160])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        libs[label] = ctypes.CDLL(out)
    return libs


def main(argv) -> int:
    import chip_smoke as cs
    flags = {a for a in argv if a.startswith("--")}
    row_major, f32 = "--row-major" in flags, "--f32" in flags
    specs = []
    for arg in (a for a in argv if a not in flags):
        label, _, rest = arg.partition("=")
        src, _, wrap = (rest or os.path.join(_build.CSRC, "sweep.cu")) \
            .partition("@")
        specs.append((label, os.path.abspath(src),
                      _wrapper(os.path.abspath(wrap) if wrap else None)))
    if not specs or not torch.cuda.is_available():
        print("usage: [--row-major] [--f32] LABEL[=SOURCE.cu[@WRAPPER.py]] "
              "..., on a machine with a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(specs, os.path.join(ROOT, "build", "sweep_variants"))
    dev = torch.device("cuda")
    H, W = cs.H, cs.W
    results: dict = {}
    for scene, make in (("synthetic", lambda: cs.fern_synthetic(dev)),
                        ("anchor", lambda: weights.load_anchor(device=dev))):
        cfg, params, buffers = make()
        K, c2w = cs.camera(H, W, 815.0)
        g = cuda_sweep.pack_grids_kernel(params, buffers, use_bf16=not f32)
        if row_major:
            a, b, vde = plane_sweep.prepare_frame(cfg, H, W, K, c2w, device=dev)
        else:
            a, b, vde, _ = cuda_sweep.prepare_frame(cfg, H, W, K, c2w,
                                                    device=dev)
        mlp = plane_sweep.mlp_layers(params["rgbnet"])
        X, Y, _ = cfg.world_size
        kw = dict(Xl=X, Yl=Y, mask_ch=g.mask_ch, k0_dim=cfg.k0_dim,
                  interval=float(cfg.voxel_size_ratio),
                  fast_thres=float(cfg.fast_color_thres),
                  spatial_pe=cfg.spatial_pe, act_type=cfg.act_type)
        del params, buffers

        def call(label, wrap):
            _build._loaded["sweep"] = libs[label]
            return wrap.sweep(g.packed, g.act_shift, a, b, vde, mlp, **kw)

        ref = plane_sweep.assemble(*plane_sweep.sweep_plain(
            g.packed, g.act_shift, a, b, vde, mlp, **kw), H, W, 1.0)
        for label, _, wrap in specs:
            got = plane_sweep.assemble(*call(label, wrap), H, W, 1.0)
            torch.cuda.synchronize()
            mx, frac = cs.sweep_errors(got, ref, tie=cs.SWEEP_TOL["tie"])
            print(f"{scene} {label}: vs plain max abs {mx:.3e}, pixels above "
                  f"{cs.SWEEP_TOL['tie']:.0e} {frac:.4%}", flush=True)
        del ref, got
        for label, _, wrap in specs + specs[::-1]:
            ms = cs.cuda_ms(lambda: call(label, wrap), 3)
            results.setdefault(scene, {}).setdefault(label, []).append(ms)
            print(f"{scene} {label}: {ms:.3f} ms", flush=True)
        del g, a, b, vde
        torch.cuda.empty_cache()
    _build._loaded.pop("sweep", None)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
