#!/usr/bin/env python3
"""Floor probes of the plane sweep's loop skeleton on the card.

What does one (tile, plane) iteration of a sweep kernel cost before it does
useful work? ``csrc/probe_floor.cu`` runs the fern-scale iteration structure
(Z = 256 planes x T = 768 tiles in groups of 24, one thread block per
group, window K = 56 padded to 64 rows x 896 columns, 1024 rays) with one
suspect added at a time: the empty double loop, a block barrier, a
shared-memory read, a window read at an offset computed in the loop, one
bf16 tensor-core product of the window, and a 3-slot ``cp.async`` ring that
streams one stripe per plane from device memory. It is the counterpart, for
an H100, of the JAX package's ``tools/perf/probe_floor.py``.

Every kernel returns a checksum that is reproduced here in closed form or by
a torch expression (the data are small integers drawn from a seed, so the
float32 sums are exact); a mismatch raises.

Run on a machine with the card, from the repository root:

    python3 -m fourk_nerf_torch.tools.probe_floor
"""

from __future__ import annotations

import ctypes
import json
import time

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.ops import _build

Z, T, G = 256, 768, 24       # planes, tiles, tiles per group
PW, R = 896, 1024            # window columns, rays
KW = 64                      # window rows: K = 56 padded to the wmma step
RING_ROWS, RING_COLS = 56, 576   # one plane's stripe in the copy ring, bf16
LOOP_MODES = ("empty", "empty_sync", "smem_read", "dyn_window")
_P = ctypes.c_void_p
_I = ctypes.c_int


def _time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def window_origin(g: int, scols: int):
    """Row and column of tile ``g``'s window in the source stripe, as the
    kernels compute them inside the loop."""
    return (g % 2) * 8, (g * 128) % (scols - PW + 128)


def run(device=None, *, seed: int = 0, reps: int = 3) -> dict:
    """Run every probe once for its checksum and ``reps`` times for its
    time. Returns ``{"probes": {name: {...}}, "device": ...}`` with the
    bytes and tensor-core operations the probes need, for a bound, the
    number of kernel launches a run makes (``"launches"``) and, as
    ``"library_ms"``, the time of the window product through
    ``torch.matmul`` (the loops and the ring have no library call); raises
    ``AssertionError`` when a checksum does not match. ``run.launches``
    counts the kernel launches."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_floor: the probes are CUDA kernels and "
                           "need the card")
    lib = _build.load("probe_floor")
    for fn, argtypes in (
            (lib.probe_floor_loop, [_I, _P, _P, _I, _I, _I, _I, _P]),
            (lib.probe_floor_mma, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
            (lib.probe_floor_ring, [_P, _P, _I, _I, _I, _P]),
            (lib.probe_floor_stripe_rows, []),
            (lib.probe_floor_stripe_cols, []),
            (lib.probe_floor_stripe_ld, [])):
        fn.argtypes, fn.restype = argtypes, _I
    srows, scols = lib.probe_floor_stripe_rows(), lib.probe_floor_stripe_cols()
    sld = lib.probe_floor_stripe_ld()  # row stride: scols plus bank padding
    groups = T // G
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def ints(shape):
        return torch.as_tensor(rng.integers(-1, 2, shape).astype(np.float32),
                               device=dev)

    stripe = ints((srows, sld)).to(bf).contiguous()
    wx = ints((KW, R)).to(bf).contiguous()
    probes = {}
    plain_s = 0.0
    mma_reps = max(1, reps - 1)
    # a warm-up and the timed calls of four loops, the product and the ring
    planned = len(LOOP_MODES) * (1 + reps) + (1 + mma_reps) + (1 + reps)

    def check(name, err):
        _build.check(lib, "probe_floor_error_string", err,
                     f"probe_floor {name}")
        run.launches += 1

    def hold(name, got, want):
        """Max abs difference of a checksum from its plain version; any
        difference raises (the sums are exact)."""
        err = float((got.double() - want.double()).abs().max())
        if err != 0.0:
            raise AssertionError(f"probe_floor {name}: checksum off by {err}")
        return err

    # the four loop kernels
    t0 = time.perf_counter()
    sf = stripe.float()
    tid = torch.arange(256, device=dev)
    want = {"empty": torch.full((256,), float(Z * G), device=dev),
            "smem_read": sf[0, :256] * (Z * G)}
    want["empty_sync"] = want["empty"]
    dyn = torch.zeros(256, device=dev)
    for g in range(G):
        row, col = window_origin(g, scols)
        dyn += sf[row + tid // 128, col + tid % 128]
    want["dyn_window"] = dyn * Z
    torch.cuda.synchronize(dev)
    plain_s += time.perf_counter() - t0
    for mode, name in enumerate(LOOP_MODES):
        out = torch.full((groups, 256), -1.0, device=dev)

        def launch(mode=mode, out=out, name=name):
            check(name, lib.probe_floor_loop(mode, stripe.data_ptr(),
                                             out.data_ptr(), groups, Z, G,
                                             PW, stream))

        ms = _time_ms(launch, reps)
        probes[name] = {"ms": ms, "ns_per_tile_plane": ms * 1e6 / (Z * T),
                        "max_abs_err": hold(name, out, want[name][None])}

    # the window's tensor-core product
    out = torch.full((groups, 8, 16, 16), -1.0, device=dev)

    def launch_mma():
        check("window_mma", lib.probe_floor_mma(
            stripe.data_ptr(), wx.data_ptr(), out.data_ptr(), groups, Z, G,
            PW, R, stream))

    ms = _time_ms(launch_mma, mma_reps)
    t0 = time.perf_counter()
    tiles = torch.zeros((16, 16), dtype=torch.float64, device=dev)
    for g in range(G):
        row, col = window_origin(g, scols)
        prod = sf[row:row + KW, col:col + PW].double().t() @ wx.double()
        tiles += prod.reshape(PW // 16, 16, R // 16, 16).sum((0, 2))
    tiles *= Z
    torch.cuda.synchronize(dev)
    plain_s += time.perf_counter() - t0
    flop = 2.0 * KW * PW * R * Z * T
    probes["window_mma"] = {
        "ms": ms, "ns_per_tile_plane": ms * 1e6 / (Z * T),
        "max_abs_err": hold("window_mma", out.double().sum(1), tiles[None]),
        "tflops": flop / (ms * 1e-3) / 1e12,
        "us_per_product": ms * 1e3 / (Z * G),
        "thread_blocks": groups}
    # the same products through the library: the T windows of one plane as
    # one bf16 matmul, once per plane
    wins = torch.stack([stripe[row:row + KW, col:col + PW] for row, col in
                        (window_origin(g, scols) for g in range(G))])
    lhs = wins.transpose(1, 2).repeat(groups, 1, 1).reshape(T * PW, KW)
    lhs = lhs.contiguous()
    prod = torch.empty((T * PW, R), dtype=bf, device=dev)

    def library_mma():
        for _ in range(Z):
            torch.mm(lhs, wx, out=prod)

    library_ms = _time_ms(library_mma, 1)
    del prod, lhs

    # the copy ring: every group streams its own Z stripes from device memory
    chunks = RING_ROWS * RING_COLS * 2 // 16
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-3, 4, (groups, Z, chunks, 8), generator=gen,
                           device=dev, dtype=torch.int8).to(bf)
    out = torch.full((groups, 256), -1.0, device=dev)

    def launch_ring():
        check("copy_ring", lib.probe_floor_ring(
            packed.data_ptr(), out.data_ptr(), groups, Z, chunks, stream))

    ms = _time_ms(launch_ring, reps)
    t0 = time.perf_counter()
    k = torch.arange(Z, device=dev)
    idx = (tid[None, :] * 15 + k[:, None] * 7) % chunks          # [Z, 256]
    want_ring = packed.float().sum(-1)[:, k[:, None], idx].sum(1)
    torch.cuda.synchronize(dev)
    plain_s += time.perf_counter() - t0
    stripe_bytes = chunks * 16
    probes["copy_ring"] = {
        "ms": ms, "stripe_bytes": stripe_bytes, "copies": groups * Z,
        "max_abs_err": hold("copy_ring", out, want_ring),
        "ns_per_copy": ms * 1e6 / Z,
        "gb_per_s": groups * Z * stripe_bytes / (ms * 1e-3) / 1e9,
        "gb_per_s_per_block": Z * stripe_bytes / (ms * 1e-3) / 1e9,
        "thread_blocks": groups}
    # each input read once and each checksum written once, per kernel
    n_in = stripe.numel() * 2
    moved = (4 * n_in + (n_in + wx.numel() * 2) + packed.numel() * 2
             + 4 * (5 * groups * 256 + groups * 8 * 256))
    return {"device": torch.cuda.get_device_name(dev),
            "shape": {"Z": Z, "T": T, "G": G, "K": KW, "pw": PW, "R": R,
                      "window_source": [srows, scols]},
            "probes": probes, "plain_ms": plain_s * 1e3,
            "library_ms": library_ms, "launches": planned,
            "bytes": moved, "bf16_flop": flop}


run.launches = 0


def report(res: dict) -> list:
    """The result of :func:`run` as printable lines."""
    lines = [f"probe_floor on {res['device']}: {json.dumps(res['shape'])}"]
    for name, p in res["probes"].items():
        if name == "copy_ring":
            lines.append(
                f"  copy_ring: {p['ms']:.3f} ms, {p['ns_per_copy']:.0f} ns "
                f"per copy of {p['stripe_bytes']} B in one block's ring "
                f"({p['copies']} copies over {p['thread_blocks']} blocks), "
                f"{p['gb_per_s']:.1f} GB/s in all, "
                f"{p['gb_per_s_per_block']:.2f} GB/s per block")
        else:
            extra = (f", {p['tflops']:.2f} TFLOP/s on {p['thread_blocks']} "
                     f"blocks, {p['us_per_product']:.2f} us per product"
                     if name == "window_mma" else "")
            lines.append(f"  {name}: {p['ms']:.3f} ms, "
                         f"{p['ns_per_tile_plane']:.2f} ns per tile-plane"
                         f"{extra}")
    lines.append(f"  window_mma through torch.mm on the whole card: "
                 f"{res['library_ms']:.3f} ms")
    return lines


if __name__ == "__main__":
    for line in report(run()):
        print(line, flush=True)
