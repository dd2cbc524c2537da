#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fourk_nerf_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build both CUDA kernels from ``fourk_nerf_torch/csrc`` (one nvcc per
     source, in parallel) and print the build time and ptxas summary;
  2. sweep kernel vs its plain version on a small scene (viewdir PE 4,
     spatial PE 2, mask at grid resolution), float32 and bf16 paths;
  3. dense-block kernel vs its plain version, plain and tail mode, on a
     100x150 frame that does not divide the 8x16 tile;
  4. the 4K frame at full width, synthetic scene (the fern geometry of
     the JAX package's bench: 363x405x256 grid, 9-ch k0, rgbnet 3x64,
     density N(-2,2), 50% random mask, numpy seed 0) -> 1008x756 render ->
     SFTNet (64 feat, 5 RRDBs, grow 32, seeded) -> 4032x3024: launch counts,
     finiteness, kernel vs plain on the main path's inputs, timings;
  5. the same frame on the trained-content anchor
     ``tools/assets/med_sr_grids_f16.npz`` upsampled onto that geometry;
  6. one JSON line per kernel summary, then the result line.

The script imports nothing of JAX. It exits with code 2, printing no
result, when no CUDA device is present or the ``fourk_nerf_torch``
package is not beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 756, 1008          # LLFF fern LR frame
SCALE = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12         # H100 SXM, non-tensor
BF16_FLOPS = 989e12        # H100 SXM, dense tensor core
SWEEP_TOL = dict(tie=2e-4, tie_frac=0.02, max=0.05)
RDB_TOL = 0.05             # max abs, as the JAX package's dense-block test
SR_TOL = 0.1               # max abs of the full decode, kernel vs plain


def log(*a):
    print(*a, flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    import torch
    fn()
    sync()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync()
    return e0.elapsed_time(e1) / reps


def sweep_errors(got: dict, ref: dict, *, tie: float):
    """Per-pixel max error over rgb_marched, depth and alphainv_last; the
    share of pixels above ``tie`` counts nearest-mask tie flips."""
    import torch
    err = torch.zeros(got["depth"].shape, device=got["depth"].device)
    for k in ("rgb_marched", "depth", "alphainv_last"):
        d = (got[k] - ref[k]).abs()
        err = torch.maximum(err, d.amax(-1) if d.dim() == 3 else d)
    return float(err.max()), float((err > tie).float().mean())


def check_sweep(name: str, got: dict, ref: dict):
    mx, frac = sweep_errors(got, ref, tie=SWEEP_TOL["tie"])
    log(f"  {name}: max abs {mx:.3e}, pixels above {SWEEP_TOL['tie']:.0e}"
        f" (tie flips) {frac:.4%}")
    if not (frac < SWEEP_TOL["tie_frac"] and mx < SWEEP_TOL["max"]):
        raise AssertionError(f"sweep kernel disagrees with plain ({name})")
    return mx


def phase_build():
    from fourk_nerf_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[1] build: {time.perf_counter() - t0:.1f} s total")
    for name, (sec, text) in logs.items():
        log(f"  {name}.cu: {sec:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"    {line.strip()}")


def small_scene(dev, seed=5):
    import torch
    from fourk_nerf_torch.models import dmpigo
    D = 32
    cfg = dmpigo.make_config(
        xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
        num_voxels=64 * 64 * D, mpi_depth=D, fast_color_thres=1.0 / D / 5,
        rgbnet_dim=9, rgbnet_width=64, viewbase_pe=4, spatial_pe=2)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    params["density"] = t(rng.normal(-1, 2, params["density"].shape)
                          .astype(np.float32))
    params["k0"] = t(rng.normal(0, 1, params["k0"].shape).astype(np.float32))
    buffers["mask_cache"] = t(rng.uniform(size=cfg.world_size) < 0.7)
    return cfg, params, buffers


def camera(h, w, f):
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 1.0
    return K, c2w[:3, :4]


def phase_sweep_small(dev):
    from fourk_nerf_torch.ops import cuda_sweep, plane_sweep
    cfg, params, buffers = small_scene(dev)
    h, w = 96, 128
    K, c2w = camera(h, w, 120.0)
    log("[2] sweep kernel vs plain, small scene (viewbase_pe 4, spatial_pe 2,"
        f" grid {cfg.world_size}, {h}x{w})")
    kw = dict(stepsize=1.0, bg=0.25, device=dev)
    ref32 = plane_sweep.render_frame(cfg, params, buffers, h, w, K, c2w,
                                     use_bf16=False, **kw)
    ref16 = plane_sweep.render_frame(cfg, params, buffers, h, w, K, c2w,
                                     use_bf16=True, **kw)
    got32 = cuda_sweep.render_frame_cuda(cfg, params, buffers, h, w, K, c2w,
                                         use_bf16=False, **kw)
    got16 = cuda_sweep.render_frame_cuda(cfg, params, buffers, h, w, K, c2w,
                                         use_bf16=True, **kw)
    sync()
    check_sweep("f32 grid vs plain f32", got32, ref32)
    check_sweep("bf16 path vs plain bf16 path", got16, ref16)
    # the bf16 path (grid, x weights and MLP rounded to bf16, as the JAX
    # kernel's use_bf16) vs the float32 reference: rounding at 2^-9
    # relative moves alphas and features a little; the mean error must
    # stay well under one 8-bit colour level
    d = (got16["rgb_marched"] - ref32["rgb_marched"]).abs()
    mean, mx = float(d.mean()), float(d.max())
    log(f"  bf16 path vs plain f32: rgb max abs {mx:.3e}, mean {mean:.3e}")
    if not (mean < 2e-3 and mx < 0.1):
        raise AssertionError("bf16 sweep too far from the f32 plain")


def phase_rdb_small(dev, sr_model):
    import torch
    from fourk_nerf_torch.ops import cuda_sr
    h, w = 100, 150
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev).to(
        torch.bfloat16).contiguous()
    x, c, xin = (t(rng.normal(size=(h, w, n))) for n in (64, 32, 64))
    body = sr_model.body0
    log(f"[3] dense-block kernel vs plain, {h}x{w} (tile 8x16 does not "
        "divide it)")
    worst = 0.0
    for mode, wts, xi in (
            ("plain", cuda_sr.pack_rdb_weights(body.rdb1), None),
            ("tail", cuda_sr.pack_rdb_weights(body.rdb3, body.sft0), xin)):
        got = cuda_sr.rdb_apply(x, c, wts, xin=xi)
        ref = cuda_sr.rdb_plain(x, c, wts, xin=xi)
        sync()
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        log(f"  {mode}: max abs {err:.3e} (|ref| max "
            f"{float(ref.float().abs().max()):.2f})")
        if not err <= RDB_TOL:
            raise AssertionError(f"dense-block kernel disagrees ({mode})")
    return worst


def fern_synthetic(dev):
    import torch
    from fourk_nerf_torch import weights
    from fourk_nerf_torch.models import dmpigo
    cfg = weights.fern_config(rgbnet_dim=9, rgbnet_depth=3, rgbnet_width=64)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    params["density"] = torch.as_tensor(
        rng.normal(-2.0, 2.0, params["density"].shape).astype(np.float32),
        device=dev)
    buffers["mask_cache"] = torch.as_tensor(
        rng.uniform(size=cfg.mask_cache_world_size) < 0.5, device=dev)
    return cfg, params, buffers


def run_frame(label, cfg, params, buffers, sr_model, dev):
    """Phases 4/5: one frame through the pipeline with the launch counts,
    checks against the plain versions, then timings. Returns a dict of
    the measured numbers."""
    import torch
    from fourk_nerf_torch.ops import cuda_sr, cuda_sweep, plane_sweep
    from fourk_nerf_torch.pipeline import FramePipeline

    K, c2w = camera(H, W, 815.0)
    pipe = FramePipeline(cfg, params, buffers, sr_model, device=dev)
    sync()

    # the main path, counted
    cuda_sweep.sweep.launches = 0
    cuda_sr.rdb_apply.launches = 0
    sr, enc = pipe(H, W, K, c2w)
    sync()
    launches = {"sweep": cuda_sweep.sweep.launches,
                "rdb": cuda_sr.rdb_apply.launches}
    log(f"  main-path launches: {launches}")
    if launches != {"sweep": 1, "rdb": 3 * sr_model.num_block}:
        raise AssertionError(f"unexpected launch counts {launches}")
    if tuple(sr.shape) != (1, H * SCALE, W * SCALE, 3):
        raise AssertionError(f"SR shape {tuple(sr.shape)}")
    for k in ("rgb_feature", "depth", "alphainv_last"):
        if not bool(torch.isfinite(enc[k]).all()):
            raise AssertionError(f"non-finite encoder {k}")
    if not bool(torch.isfinite(sr).all()):
        raise AssertionError("non-finite SR output")
    log(f"  shapes: rgb_feature {tuple(enc['rgb_feature'].shape)}, "
        f"sr {tuple(sr.shape)}; all finite; rgb_feature mean "
        f"{float(enc['rgb_feature'].mean()):.4f}, alphainv_last mean "
        f"{float(enc['alphainv_last'].mean()):.4f}")

    # encoder: kernel vs plain on the main path's inputs (the plain sweep
    # runs in ray chunks of 2^18)
    X, Y, _ = cfg.world_size
    a, b, vde = plane_sweep.prepare_frame(cfg, H, W, K, c2w, device=dev)
    mlp = plane_sweep.mlp_layers(params["rgbnet"])
    kw = dict(Xl=X, Yl=Y, mask_ch=pipe.packed.mask_ch, k0_dim=cfg.k0_dim,
              interval=float(cfg.voxel_size_ratio),
              fast_thres=float(cfg.fast_color_thres),
              spatial_pe=cfg.spatial_pe, act_type=cfg.act_type)
    g = pipe.packed
    stats: dict = {}
    t0 = time.perf_counter()
    ref = plane_sweep.sweep_plain(g.packed, g.act_shift, a, b, vde, mlp,
                                  stats=stats, **kw)
    sync()
    plain_sweep_ms = (time.perf_counter() - t0) * 1e3
    ref = plane_sweep.assemble(*ref, H, W, 1.0)
    sweep_err = check_sweep("encoder kernel vs plain (bf16 path)", enc, ref)
    log(f"  samples in bounds and live {stats['samples']}, with non-zero "
        f"weight (MLP evaluated) {stats['mlp_samples']}")

    sweep_ms = cuda_ms(lambda: cuda_sweep.sweep(g.packed, g.act_shift, a, b,
                                                vde, mlp, **kw), 3)
    # bound: the grid's live channels (density, k0, mask; not the padding)
    # read once, rays in, maps out; the MLP of the samples with a non-zero
    # weight at the peak of its type (bf16 tensor cores on the bf16 path,
    # the JAX kernel's MLP type there)
    cin0 = mlp[0][0].shape[0]
    width = mlp[0][0].shape[1]
    mlp_flop = 2 * (cin0 * width + (len(mlp) - 2) * width * width + width * 3)
    Z, Xp, Yp, _ = g.packed.shape
    sweep_bytes = (Z * Xp * Yp * (g.mask_ch + 1) * g.packed.element_size()
                   + (a.numel() + b.numel() + vde.numel()) * 4 + H * W * 5 * 4)
    t_bytes = sweep_bytes / HBM_BYTES_PER_S * 1e3
    bf16 = g.packed.dtype == torch.bfloat16
    t_ops = stats["mlp_samples"] * mlp_flop \
        / (BF16_FLOPS if bf16 else FP32_FLOPS) * 1e3
    sweep_bound = max(t_bytes, t_ops)
    log(f"  sweep kernel {sweep_ms:.3f} ms, plain {plain_sweep_ms:.1f} ms, "
        f"bound {sweep_bound:.3f} ms (bytes {t_bytes:.4f} ms, "
        f"{'bf16' if bf16 else 'fp32'} MLP ops {t_ops:.4f} ms)")

    # decoder: kernel vs plain at the main path's dense-block input
    prep = pipe.sr
    feat = enc["rgb_feature"][None]
    depth = enc["depth"][None, ..., None]
    _, _, body, ch = cuda_sr.sftnet_head(prep, feat, depth)
    rdb_err = 0.0
    for j, xi in ((0, None), (2, body)):
        got = cuda_sr.rdb_apply(body, ch, prep.packs[j], xin=xi)
        want = cuda_sr.rdb_plain(body, ch, prep.packs[j], xin=xi)
        rdb_err = max(rdb_err, float((got.float() - want.float()).abs().max()))
    log(f"  dense block kernel vs plain at {H}x{W}: max abs {rdb_err:.3e}")
    if not rdb_err <= RDB_TOL:
        raise AssertionError("dense-block kernel disagrees on the main path")
    rdb_ms = cuda_ms(lambda: cuda_sr.rdb_apply(body, ch, prep.packs[0]), 5)
    rdb_tail_ms = cuda_ms(
        lambda: cuda_sr.rdb_apply(body, ch, prep.packs[2], xin=body), 5)
    rdb_plain_ms = cuda_ms(lambda: cuda_sr.rdb_plain(body, ch, prep.packs[0]), 2)
    mac_px = 9 * sum(ci * co for ci, co in zip(cuda_sr._CIN, cuda_sr._COUT)) \
        + 2 * (32 * 32 + 32 * 64) + 2 * (32 * 32 + 32 * 32)
    rdb_ops = 2 * mac_px * H * W / BF16_FLOPS * 1e3
    rdb_bytes = (H * W * (64 + 32 + 64) * 2
                 + prep.packs[0].conv.numel() * 2) / HBM_BYTES_PER_S * 1e3
    rdb_bound = max(rdb_ops, rdb_bytes)
    log(f"  dense block kernel {rdb_ms:.3f} ms (tail {rdb_tail_ms:.3f} ms), "
        f"plain {rdb_plain_ms:.1f} ms, bound {rdb_bound:.3f} ms "
        f"({mac_px} MAC/px at the bf16 peak; bytes {rdb_bytes:.4f} ms)")

    sr_ref = cuda_sr.sftnet_apply_plain(prep, feat, depth)
    sync()
    d = (sr - sr_ref).abs()
    sr_err, sr_mean = float(d.max()), float(d.mean())
    log(f"  SR kernel chain vs plain chain: max abs {sr_err:.3e}, mean "
        f"{sr_mean:.3e} (|ref| max {float(sr_ref.abs().max()):.3f})")
    if not sr_err <= SR_TOL:
        raise AssertionError("SR output disagrees with the plain chain")
    del sr_ref, d, ref

    # timings: one warm-up frame, then the median of five
    pipe(H, W, K, c2w)
    sync()
    enc_t, sr_t, tot_t = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        e = pipe.encode(H, W, K, c2w)
        sync()
        t1 = time.perf_counter()
        pipe.decode(e)
        sync()
        t2 = time.perf_counter()
        enc_t.append((t1 - t0) * 1e3)
        sr_t.append((t2 - t1) * 1e3)
        tot_t.append((t2 - t0) * 1e3)
    out = {"enc_ms": statistics.median(enc_t), "sr_ms": statistics.median(sr_t),
           "fps": 1e3 / statistics.median(tot_t)}
    log(f"  {label}: " + json.dumps({k: round(v, 3) for k, v in out.items()}))
    profile_frame(pipe, K, c2w)
    out.update(launches=launches, sweep_err=sweep_err, sweep_ms=sweep_ms,
               plain_sweep_ms=plain_sweep_ms, sweep_bound=sweep_bound,
               sweep_bound_by="bytes" if t_bytes >= t_ops else "operations",
               rdb_err=rdb_err, rdb_ms=rdb_ms, rdb_plain_ms=rdb_plain_ms,
               rdb_bound=rdb_bound,
               rdb_bound_by="operations" if rdb_ops >= rdb_bytes else "bytes")
    return out


def profile_frame(pipe, K, c2w):
    """One frame under torch.profiler: device time by kernel (top 8) and
    the device's idle share of the frame's wall time. Only device-side
    kernel rows are summed (operator rows repeat their kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(H, W, K, c2w)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        log("  profiler: no device time recorded")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms > wall_ms:
        raise AssertionError(f"device kernel time {busy_ms:.1f} ms exceeds "
                             f"the frame's wall time {wall_ms:.1f} ms: the "
                             "kernel rows are counted twice")
    log(f"  profiler: frame wall {wall_ms:.1f} ms (profiled), device kernels "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for us, key, n in rows[:8]:
        log(f"    {us / 1e3:9.2f} ms  x{n:<4d} {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "fourk_nerf_torch")):
        print("chip_smoke: the fourk_nerf_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from fourk_nerf_torch import weights

    phase_build()
    phase_sweep_small(dev)
    sr_model = weights.sftnet_init(num_block=5, seed=1, device=dev)
    phase_rdb_small(dev, sr_model)

    log("[4] 4K frame, synthetic fern-scale scene")
    syn = run_frame("synthetic", *fern_synthetic(dev), sr_model, dev)
    torch.cuda.empty_cache()

    log(f"[5] 4K frame, trained anchor "
        f"{os.path.relpath(weights.ANCHOR_ASSET, HERE)}")
    anc = run_frame("anchor", *weights.load_anchor(device=dev), sr_model, dev)
    log(f"  anchor asset: {os.path.basename(weights.ANCHOR_ASSET)}, sweep "
        f"{anc['sweep_ms']:.3f} ms, bound {anc['sweep_bound']:.3f} ms")

    kernels = [
        {"name": "sweep", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/sweep.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_sweep.py:614",
         "launches": syn["launches"]["sweep"],
         "max_abs_err": syn["sweep_err"], "ms": syn["sweep_ms"],
         "plain_ms": syn["plain_sweep_ms"], "bound_ms": syn["sweep_bound"],
         "bound_by": syn["sweep_bound_by"], "library_ms": None},
        {"name": "rdb", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/rdb.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_sr.py:481",
         "launches": syn["launches"]["rdb"],
         "max_abs_err": syn["rdb_err"], "ms": syn["rdb_ms"],
         "plain_ms": syn["rdb_plain_ms"], "bound_ms": syn["rdb_bound"],
         "bound_by": syn["rdb_bound_by"], "library_ms": None},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
