"""Render cells: frames back to back through ``FramePipeline.__call__``.

One client in a closed loop renders the next pose of the mix's camera
path as soon as the last frame is synced, as a fly-through render does.
A frame's latency runs from the pose handed in to the decoded frame
synced. A sample of the window's frames, drawn from the seed, is kept and
judged against the reference once the window has closed.

A render mix holds (and may hold only) ``kind``, ``path`` (the camera
path), ``launches_per_frame`` (the kernel launches every frame must make,
by counter: ``<ops module>.<wrapper>``), ``pipeline`` (optional keyword
arguments of ``FramePipeline``, such as ``fuse_rrdb``), ``warmup_frames``
and ``judged_frames``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, judge, program, timing
from portbench.reference import common as C
from portbench.reference import field, sftnet

PROFILED_FRAMES = 10
KEYS = {"kind", "path", "launches_per_frame", "pipeline", "warmup_frames",
        "judged_frames"}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_frame(cfg, params, buffers, weights, K, c2w, *, rnd=C.identity):
    """The reference's encoder maps and decoded frame of one pose."""
    cam = cfg["camera"]
    with C.full_fp32():
        r = field.render_frame(cfg["family"], cfg["model"], cam, params,
                               buffers, K, c2w, bg=cam["bg"], rnd=rnd)
        with torch.no_grad():
            frame = sftnet.forward(weights, cfg["decoder"],
                                   r["rgb_feature"][None],
                                   r["depth"][None, ..., None], rnd=rnd)
    return {"rgb_feature": r["rgb_feature"], "depth": r["depth"],
            "frame": frame, "weighted": r["weighted"], "valid": r["valid"]}


def run(ctx) -> dict:
    """One run of a render cell; returns the run's record (see
    ``portbench.run``)."""
    from fourk_nerf_torch.models import sr_esrnet
    from fourk_nerf_torch.pipeline import FramePipeline

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    if set(tr) - KEYS:
        raise ValueError(f"a render mix takes no {sorted(set(tr) - KEYS)}")
    cam, dec, m = cfg["camera"], cfg["decoder"], cfg["model"]
    H, W = cam["H"], cam["W"]
    K = inputs.intrinsics(cam)
    poses = inputs.path(tr["path"], seed)
    params, buffers = inputs.scene(cfg, seed, dev)
    weights = inputs.decoder(cfg, seed, dev)
    with torch.device(dev):
        sr = sr_esrnet.SFTNet(scale=dec["scale"], num_feat=dec["num_feat"],
                              num_block=dec["num_block"],
                              num_grow_ch=dec["num_grow_ch"],
                              num_cond=dec["num_cond"])
    sr.load_state_dict(weights)
    sr.eval()
    pipe = FramePipeline(program.model_config(cfg), params, buffers, sr,
                         stepsize=m["stepsize"], near=cam.get("near", 0.0),
                         bg=cam["bg"], device=dev, **tr.get("pipeline", {}))
    for i in range(tr["warmup_frames"]):
        pipe(H, W, K, poses[i % len(poses)])
    _sync(dev)
    want = tr["launches_per_frame"]
    before = program.launches()
    pipe(H, W, K, poses[0])
    _sync(dev)
    per_frame = {k: v - before[k] for k, v in program.launches().items()
                 if v != before[k]}
    if ctx.on_chip and per_frame != want:
        raise RuntimeError(f"a frame left the kernel path: launches "
                           f"{per_frame}, want {want}")
    ctx.check_modules("set-up")
    _sync(dev)
    rec = {"setup_s": time.perf_counter() - ctx.t0, "config": cfg}

    k_judged = tr["judged_frames"]
    rng = np.random.default_rng((int(seed), 6))
    kept, lat = [], []
    ev = [] if ctx.trace else None
    before = program.launches()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    i = 0
    while True:
        c2w = poses[i % len(poses)]
        t0 = time.perf_counter()
        if ev is None:
            out, enc = pipe(H, W, K, c2w)
        else:
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            enc = pipe.encode(H, W, K, c2w)
            e[1].record()
            out = pipe.decode(enc)
            e[2].record()
            ev.append(e)
        _sync(dev)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        slot = i if i < k_judged else int(rng.integers(i + 1))
        if slot < k_judged:
            got = {"i": i, "rgb_feature": enc["rgb_feature"].clone(),
                   "depth": enc["depth"].clone(), "frame": out.clone()}
            if slot < len(kept):
                kept[slot] = got
            else:
                kept.append(got)
        i += 1
        if t1 >= deadline:
            break
    rec.update(window_s=t1 - t_start, frames=i, latencies_s=lat)
    total = {k: v - before[k] for k, v in program.launches().items()
             if v != before[k]}
    if ctx.on_chip and total != {k: v * i for k, v in want.items()}:
        raise RuntimeError(f"the window left the kernel path: launches "
                           f"{total} over {i} frames")
    ctx.log(f"launches per frame {per_frame}; frames {i} in "
            f"{rec['window_s']:.6f} s")
    if ev is not None:
        rec["events"] = {"encode_ms": [a.elapsed_time(b) for a, b, _ in ev],
                         "decode_ms": [b.elapsed_time(c) for _, b, c in ev]}
        judged = [poses[g["i"] % len(poses)] for g in kept]

        def frames():
            for q in range(PROFILED_FRAMES):
                pipe(H, W, K, judged[q % len(judged)])

        rec["profile"] = timing.profile(frames, lambda: _sync(dev))
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    del pipe, sr, out, enc
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    pairs, weighted, valid = [], [], []
    for got in kept:
        ref = reference_frame(cfg, params, buffers, weights, K,
                              poses[got["i"] % len(poses)])
        weighted.append(ref.pop("weighted"))
        valid.append(ref.pop("valid"))
        pairs.append((got, ref))
    # the profiled frames cycle through the judged poses, so this mean is
    # theirs too
    rec["counts"] = {"weighted_per_frame": float(np.mean(weighted)),
                     "valid_per_frame": float(np.mean(valid))}
    ctx.log(f"samples a judged frame: valid {valid}, weighted {weighted}")
    rec["numbers"] = judge.render_numbers(pairs)
    rec["attempted"] = i
    return rec
