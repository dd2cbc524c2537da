"""Readings that set a joint cell's limits, on the chip at the cell's own size.

    python3 -m portbench.calibrate_joint --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

In one process: the program's numbers on each of ``--seeds`` (a run of the
cell with a short window, ``portbench.calibrate``'s own loop), then on each
of ``--control-seeds`` the control's numbers and the faults': the reference
put in the program's place, computed one precision below the
configuration's (every generator conv's operands in TF32 for the stated
float32 with TF32 off), and three faults planted in it: a generator leaf's
gradient 1% off as it is produced, the encoder's grid update left out
(the grid window's update, on the window path), and half of the patch left
out of the loss (the mean over the rest). Each is compared with the sound
reference as the program is. Prints one JSON line per reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import calibrate, inputs, judge, run
from portbench.drivers import joint as joint_driver
from portbench.reference import common as C
from portbench.reference import joint as ref_joint
from portbench.reference import train as ref_train

FAULTS = ("grad_gen", "grid_update_off", "half_patch")
GEN_LEAF = "srnet.conv_first.weight"
_LOSS = ref_joint.loss_of


def _half_loss(out, sr, target, target_hr, tr, n):
    """The joint loss over the first half of the patch's rows (the first
    half of its rays, row-major), each mean over the half."""
    h = n // 2
    Z = out["weights"].shape[1]
    keep = out["sel"] // Z < h
    half = {k: v[:h] if isinstance(v, torch.Tensor) and v.shape[:1] == (n,)
            else v for k, v in out.items()}
    half.update(sel=out["sel"][keep], rgb_w=out["rgb_w"][keep])
    rows = sr.shape[1] // 2
    return _LOSS(half, sr[:, :rows], target[:h], target_hr[:, :rows], tr, h)


def _planted(fault):
    """(module, attribute, replacement) of a fault planted in the
    reference."""
    if fault == "grad_gen":
        orig = ref_train.adam_step

        def adam(params, grads, opt, lrs, masked):
            grads[GEN_LEAF] = grads[GEN_LEAF] * 1.01
            return orig(params, grads, opt, lrs, masked)
        return ref_train, "adam_step", adam
    if fault == "grid_update_off":
        orig = ref_train.adam_step

        def adam(params, grads, opt, lrs, masked):
            return orig(params, grads, opt, {k: v for k, v in lrs.items()
                                             if k not in masked}, masked)
        return ref_train, "adam_step", adam
    if fault == "half_patch":
        return ref_joint, "loss_of", _half_loss
    raise ValueError(f"no fault {fault!r}")


def ref_run(cfg, tr, seed, dev, conv_rnd=C.identity, fault=None) -> dict:
    """The reference's three judged steps on the sampler's draws of a fresh
    set-up (the patches the program would draw), with ``fault``
    planted."""
    from fourk_nerf_torch.train import sr_trainer
    cam, dec, t = cfg["camera"], cfg["decoder"], cfg["train"]
    poses = inputs.views(tr["views"], cfg["data"]["train_views"], seed)
    imgs = inputs.images(len(poses), cam, seed)
    hr = joint_driver.hr_images(len(poses), cam, dec["scale"], seed, dev)
    params, buffers = inputs.scene(cfg, seed, dev)
    weights = inputs.decoder(cfg, seed, dev)
    sample = sr_trainer.make_patch_sampler(len(poses), cam["H"], cam["W"],
                                           t["N_patch"], int(seed))
    patches = [sample(tr["start_step"] + i - 1)
               for i in range(joint_driver.JUDGED_STEPS)]
    mod = attr = orig = None
    if fault is not None:
        mod, attr, repl = _planted(fault)
        orig = getattr(mod, attr)
        setattr(mod, attr, repl)
    try:
        return joint_driver.reference_steps(cfg, tr, dev, params, weights,
                                            buffers, poses, imgs, hr,
                                            patches, conv_rnd=conv_rnd)
    finally:
        if mod is not None:
            setattr(mod, attr, orig)


def joint_control(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The TF32 control and the planted faults against the float32
    reference."""
    sound = ref_run(cfg, tr, seed, dev)
    out = {"control": judge.train_numbers(
        ref_run(cfg, tr, seed, dev, conv_rnd=ref_joint.tf32_operands),
        sound)}
    for f in FAULTS:
        out[f] = judge.train_numbers(ref_run(cfg, tr, seed, dev, fault=f),
                                     sound)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate_joint")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate_joint: no CUDA device", file=sys.stderr)
        return 2
    if args.seeds:
        calibrate.main(["--workload", args.workload, "--seconds",
                        str(args.seconds), "--seeds",
                        *map(str, args.seeds)])
    dev = torch.device("cuda", 0)
    cell = run.cell_of(run.manifest(), args.workload)
    cfg, tr = inputs.config(cell["config"]), inputs.traffic(cell["traffic"])
    for s in args.control_seeds:
        with C.full_fp32():
            nums = joint_control(cfg, tr, s, dev)
        torch.cuda.empty_cache()
        print(json.dumps({"control": s, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
