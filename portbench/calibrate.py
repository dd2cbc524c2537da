"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 -m portbench.calibrate --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

In one process: the program's numbers on each of ``--seeds`` (a run of
the cell with a short window, as ``portbench.run`` makes it), then on
each of ``--control-seeds`` the control's numbers: the reference put in
the program's place, computed one precision below the configuration's
(a render cell: grids, rgbnet and decoder in fp8 e4m3 for the stated
bf16; a training cell: every matmul's operands in TF32 for the stated
float32 with TF32 off), compared with the float32 reference as the
program is. A training cell also reads faults planted in the
reference: half of each batch left out (the mean over the rest), the
first rgbnet layer's gradient 1% off as it is produced, a step that
leaves the state unchanged, and, where the configuration trains with TV,
the TV gradients left out (all of them; k0's alone, the smaller). Prints one
JSON line per reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import inputs, judge, run
from portbench.drivers import render, train as train_driver
from portbench.reference import common as C
from portbench.reference import train as ref_train


def render_control(cfg: dict, tr: dict, seed: int, dev, n: int = 2) -> dict:
    """The fp8 reference against the float32 one on ``n`` poses of the
    cell's path drawn from the seed."""
    K = inputs.intrinsics(cfg["camera"])
    poses = inputs.path(tr["path"], seed)
    params, buffers = inputs.scene(cfg, seed, dev)
    weights = inputs.decoder(cfg, seed, dev)
    rng = np.random.default_rng((int(seed), 7))
    pairs = []
    for j in rng.choice(len(poses), n, replace=False):
        ref = render.reference_frame(cfg, params, buffers, weights, K,
                                     poses[j])
        low = render.reference_frame(cfg, params, buffers, weights, K,
                                     poses[j], rnd=C.round_fp8)
        pairs.append((low, ref))
    return judge.render_numbers(pairs)


def _ref_run(cfg, tr, seed, dev, mm=C.matmul, fault=None):
    """The reference's three judged steps on the sampler's draws of a fresh
    set-up (the draws the program would make), with ``fault`` planted."""
    from fourk_nerf_torch.train import trainer
    t = cfg["train"]
    poses = inputs.views(tr["views"], cfg["data"]["train_views"], seed)
    imgs = inputs.images(len(poses), cfg["camera"], seed)
    params, buffers = inputs.scene(cfg, seed, dev)
    rays = train_driver.reference_rays(cfg, poses, imgs, dev, buffers)
    sampler = trainer.make_batch_sampler(t["ray_sampler"], rays,
                                         t["N_rand"], int(seed))
    sels = [sampler(tr["start_step"] + i - 1)[1]
            for i in range(train_driver.JUDGED_STEPS)]
    orig_step = step = ref_train.step
    if fault == "half_batch":
        def step(fam, m, tr_, p, b, opt, batch, lrs, **kw):
            h = batch[0].shape[0] // 2
            bg = kw["bg"]
            kw["bg"] = bg[:h] if isinstance(bg, torch.Tensor) else bg
            return orig_step(fam, m, tr_, p, b, opt,
                             tuple(x[:h] for x in batch), lrs, **kw)
    elif fault == "state_unchanged":
        def step(*a, **kw):
            orig = ref_train.adam_step
            ref_train.adam_step = lambda *_a, **_k: None
            try:
                return orig_step(*a, **kw)
            finally:
                ref_train.adam_step = orig
    elif fault == "tv_off":
        def step(*a, **kw):
            return orig_step(*a, **{**kw, "apply_tv": False})
    elif fault == "tv_k0_off":
        def step(fam, m, tr_, *a, **kw):
            return orig_step(fam, m, {**tr_, "weight_tv_k0": 0.0}, *a, **kw)
    elif fault == "grad_w0":
        def step(*a, **kw):
            orig = ref_train.adam_step

            def adam(params, grads, opt, lrs, masked):
                grads["rgbnet.w0"] = grads["rgbnet.w0"] * 1.01
                return orig(params, grads, opt, lrs, masked)
            ref_train.adam_step = adam
            try:
                return orig_step(*a, **kw)
            finally:
                ref_train.adam_step = orig
    ref_train.step = step
    try:
        return train_driver.reference_steps(
            cfg, tr, seed, dev, params, buffers, poses, imgs, sels,
            rays["rgb"].shape[0], mm=mm)
    finally:
        ref_train.step = orig_step


def train_control(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The TF32 control and the planted faults against the float32
    reference (TV left out only where the configuration trains with TV)."""
    sound = _ref_run(cfg, tr, seed, dev)
    out = {"control": judge.train_numbers(
        _ref_run(cfg, tr, seed, dev, mm=C.mm_tf32), sound)}
    faults = ["half_batch", "grad_w0", "state_unchanged"]
    if cfg["train"]["weight_tv_density"] > 0:
        faults.append("tv_off")
    if cfg["train"]["weight_tv_k0"] > 0:
        faults.append("tv_k0_off")
    for f in faults:
        out[f] = judge.train_numbers(_ref_run(cfg, tr, seed, dev, fault=f),
                                     sound)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = run.manifest()
    cell = run.cell_of(bench, args.workload)
    cfg, tr = inputs.config(cell["config"]), inputs.traffic(cell["traffic"])
    for s in args.seeds:
        t0 = time.perf_counter()
        r = run.run_cell(bench, args.workload, s, args.seconds, False, dev,
                         on_chip=True, t0=t0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        print(json.dumps({"program": s, "correct": r["correct"],
                          "numbers": {k: v["value"]
                                      for k, v in r["checks"].items()},
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()}}),
              flush=True)
    for s in args.control_seeds:
        with C.full_fp32():
            nums = (render_control(cfg, tr, s, dev) if tr["kind"] == "render"
                    else train_control(cfg, tr, s, dev))
        torch.cuda.empty_cache()
        print(json.dumps({"control": s, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
