#!/usr/bin/env python3
"""Six small kernels for the constructs of a transposed sweep kernel, each
held against a torch expression on the card.

``csrc/probe_ops.cu`` writes out by hand, at the shapes of the JAX package's
``tools/perf/probe_mosaic.py`` (48-row patch, 768 lanes, 1024 rays, 16
channels), the six functions that script asks the TPU compiler to lower:
``x^T y`` in float32 and with bf16 operands, a rank-3 broadcast multiply, a
strided row extraction, a row repeat and a pairwise block reduction. Limits:
0 for the four data movements (the reduction's torch expression adds in the
kernel's order), 1e-3 relative for the float32 product, and for the bf16
product 1e-5 relative against the product of the bf16-rounded operands and
2^-7 of ``|x|^T |y|`` against the float32 product (two bf16 roundings per
term).

Run on a machine with the card, from the repository root:

    python3 -m fourk_nerf_torch.tools.probe_ops
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.ops import _build

PXS, L, R = 48, 768, 1024    # patch rows, lanes, rays
Q, CP, ROW = 48, 16, 11      # blocks, channels per block, the extracted row
_P = ctypes.c_void_p
_I = ctypes.c_int


def block_reduce_plain(z, q: int, cp: int):
    """``sum_q z[(q, c), r]`` in the kernel's order: lower half plus upper
    half while the number of ``cp``-row blocks is even, then the remaining
    blocks left to right."""
    a, blocks = z, q
    while blocks % 2 == 0:
        h = a.shape[0] // 2
        a = a[:h] + a[h:]
        blocks //= 2
    out = a[:cp]
    for b in range(1, blocks):
        out = out + a[b * cp:(b + 1) * cp]
    return out


REPS = 10                    # timed launches of each kernel


def _events_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _plain(patch, wx, p16, w16, z, wy) -> dict:
    """The six functions as torch expressions."""
    return {
        "dot_tt": patch.t() @ wx,
        "dot_tt_bf16": p16.float().t() @ w16.float(),
        "r3_bcast": (z.reshape(Q, CP, R) * wy[:, None, :]).reshape(Q * CP, R),
        "strided_row": z.reshape(Q, CP, R)[:, ROW, :],
        "repeat_rows": wy.repeat_interleave(CP, dim=0),
        "block_reduce": block_reduce_plain(z, Q, CP),
    }


def run(device=None, *, seed: int = 0) -> dict:
    """Run the six kernels; returns ``{name: {"max_err", "limit", "ms",
    "library_ms"}}`` under ``"probes"`` (``library_ms``: the construct as
    one torch call, timed like the kernel), their sum as ``"library_ms"``
    and the number of kernel launches a run makes as ``"launches"``. Raises
    ``AssertionError`` when one is over its limit. ``run.launches`` counts
    the kernel launches."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_ops: the probes are CUDA kernels and need "
                           "the card")
    lib = _build.load("probe_ops")
    for fn, argtypes in (
            (lib.probe_ops_dot_tt, [_P, _P, _P, _I, _I, _I, _P]),
            (lib.probe_ops_dot_tt_bf16, [_P, _P, _P, _I, _I, _I, _P]),
            (lib.probe_ops_move, [_I, _P, _P, _P, _I, _I, _I, _I, _P]),
            (lib.probe_ops_block_reduce, [_P, _P, _I, _I, _I, _P])):
        fn.argtypes, fn.restype = argtypes, _I
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    patch, wx = normal(PXS, L), normal(PXS, R)
    z, wy = normal(Q * CP, R), normal(Q, R)
    bf = torch.bfloat16
    p16, w16 = patch.to(bf).contiguous(), wx.to(bf).contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _plain(patch, wx, p16, w16, z, wy)  # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        refs = _plain(patch, wx, p16, w16, z, wy)
        torch.cuda.synchronize(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        scale = patch.abs().t() @ wx.abs()
        # each construct as one torch call (the bf16 product in bf16, the
        # reduction as a plain sum), warmed up by the calls above
        z3 = z.reshape(Q, CP, R)
        library = {
            "dot_tt": lambda: patch.t() @ wx,
            "dot_tt_bf16": lambda: p16.t() @ w16,
            "r3_bcast": lambda: z3 * wy[:, None, :],
            "strided_row": lambda: z3[:, ROW, :].contiguous(),
            "repeat_rows": lambda: wy.repeat_interleave(CP, dim=0),
            "block_reduce": lambda: z3.sum(0),
        }
        for fn in library.values():
            fn()
        library_ms = {name: _events_ms(fn, REPS)
                      for name, fn in library.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def ptr(t):
        return t.data_ptr()

    def rel(o, ref):
        return float(((o - ref).abs() / scale).max())

    def exact(ref):
        return lambda o: float((o - ref).abs().max())

    # name -> (output shape, launch, [(what, error of the output, limit)])
    cases = {
        "dot_tt": (
            (L, R), lambda o: lib.probe_ops_dot_tt(
                ptr(patch), ptr(wx), ptr(o), PXS, L, R, stream),
            [("vs float32 matmul", lambda o: rel(o, refs["dot_tt"]), 1e-3)]),
        "dot_tt_bf16": (
            (L, R), lambda o: lib.probe_ops_dot_tt_bf16(
                ptr(p16), ptr(w16), ptr(o), PXS, L, R, stream),
            [("vs float32 matmul", lambda o: rel(o, refs["dot_tt"]), 2.0 ** -7),
             ("vs matmul of the rounded operands",
              lambda o: rel(o, refs["dot_tt_bf16"]), 1e-5)]),
        "r3_bcast": (
            (Q * CP, R), lambda o: lib.probe_ops_move(
                0, ptr(z), ptr(wy), ptr(o), Q, CP, R, ROW, stream),
            [("vs torch", exact(refs["r3_bcast"]), 0.0)]),
        "strided_row": (
            (Q, R), lambda o: lib.probe_ops_move(
                1, ptr(z), ptr(wy), ptr(o), Q, CP, R, ROW, stream),
            [("vs torch", exact(refs["strided_row"]), 0.0)]),
        "repeat_rows": (
            (Q * CP, R), lambda o: lib.probe_ops_move(
                2, ptr(z), ptr(wy), ptr(o), Q, CP, R, ROW, stream),
            [("vs torch", exact(refs["repeat_rows"]), 0.0)]),
        "block_reduce": (
            (CP, R), lambda o: lib.probe_ops_block_reduce(
                ptr(z), ptr(o), Q, CP, R, stream),
            [("vs torch", exact(refs["block_reduce"]), 0.0)]),
    }
    probes = {}
    for name, (shape, launch, checks) in cases.items():
        out = torch.full(shape, float("nan"), device=dev)
        _build.check(lib, "probe_ops_error_string", launch(out),
                     f"probe_ops {name}")
        run.launches += 1
        torch.cuda.synchronize()
        errs = [(what, fn(out), limit) for what, fn, limit in checks]

        def timed(name=name, launch=launch, out=out):
            _build.check(lib, "probe_ops_error_string", launch(out),
                         f"probe_ops {name}")
            run.launches += 1

        probes[name] = {"max_err": errs[0][1], "limit": errs[0][2],
                        "checks": [list(e) for e in errs],
                        "ms": _events_ms(timed, REPS),
                        "library_ms": library_ms[name]}
        for what, err, limit in errs:
            if not err <= limit:
                raise AssertionError(f"probe_ops {name} {what}: max error "
                                     f"{err:.3e} over its limit {limit:.3e}")
    # the reduction also agrees with a plain sum to float32 rounding
    drift = float((refs["block_reduce"]
                   - z.reshape(Q, CP, R).sum(0)).abs().max())
    # each kernel's inputs read once and its output written once
    n = {"patch": PXS * L, "wx": PXS * R, "z": Q * CP * R, "wy": Q * R}
    moved = (4 * (n["patch"] + n["wx"] + L * R)
             + 2 * (n["patch"] + n["wx"]) + 4 * L * R
             + 4 * (2 * n["z"] + n["wy"]) + 4 * (n["z"] + n["wy"])
             + 4 * (n["wy"] + n["z"]) + 4 * (n["z"] + CP * R))
    return {"device": torch.cuda.get_device_name(dev), "probes": probes,
            "block_reduce_vs_sum": drift, "plain_ms": plain_ms,
            "library_ms": sum(library_ms.values()),
            "launches": len(cases) * (1 + REPS),
            "bytes": moved, "f32_flop": 2.0 * PXS * L * R,
            "bf16_flop": 2.0 * PXS * L * R}


run.launches = 0


def report(res: dict) -> list:
    """The result of :func:`run` as printable lines."""
    lines = [f"probe_ops on {res['device']}:"]
    for name, p in res["probes"].items():
        errs = "; ".join(f"{what} {err:.3e} (limit {limit:.3e})"
                         for what, err, limit in p["checks"])
        lines.append(f"  {name}: ok, max err {errs}, "
                     f"{p['ms'] * 1e3:.1f} us (one torch call "
                     f"{p['library_ms'] * 1e3:.1f} us)")
    lines.append("  block_reduce tree vs a plain sum: "
                 f"{res['block_reduce_vs_sum']:.3e}")
    return lines


if __name__ == "__main__":
    for line in report(run()):
        print(line, flush=True)
