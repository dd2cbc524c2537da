"""Joint cells: the VC-Encoder and its x4 VC-Decoder trained together, each
step the joint loop's own (``sr_trainer.JointSteps``, which
``scene_rep_reconstruction_sr_patch`` calls): the patch sampler's draw,
the gather of the patch's rays and targets, the grid window's origin, the
decayed lrs, the background noise, the TV switch and ``SRTrainStep``.

Set-up builds the steps with their parameters and both optimizer states
and drives them through their first three steps on the window's own call;
the reference (``reference/joint.py``) follows those three from the same
initial parameters on the program's draws once the window has closed. The
window then runs on the same objects, unsynced, and syncs the device at
its end. With ``--trace 1`` 12 more steps run under ``torch.profiler``
(the idle share), then 12 with the program's spans on and no profiler
(the span readers). Left out of the window, as the training cells leave
them out: the loop's occupancy refresh every 1000 steps, its validation
and its checkpoints.

A joint mix holds (and may hold only) ``kind``, ``views`` (the path its
training cameras are set on) and ``start_step`` (the global step of the
first judged step, which sets the lrs and the TV switch, and with it the
patch render's path).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, judge, program, timing
from portbench.drivers import train as train_driver
from portbench.reference import common as C
from portbench.reference import joint as ref_joint
from portbench.reference import train as ref_train

JUDGED_STEPS = 3
PROFILED_STEPS = 12
KEYS = {"kind", "views", "start_step"}
HR_SALT = 8


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hr_images(n: int, cam: dict, scale: int, seed: int, device):
    """High-resolution targets ``[n, H*scale, W*scale, 3]``: uniform noise
    from the seed, drawn on the device (the LLFF loader's ``srgt``, which
    the joint loop holds on the device)."""
    g = inputs.generator(seed, HR_SALT, device)
    return torch.rand((n, cam["H"] * scale, cam["W"] * scale, 3),
                      generator=g, device=device)


def _raw_name(name: str) -> str:
    """A generator leaf of the program's flax-named tree under the module's
    (and the reference's) name: ``kernel`` is ``weight``."""
    return name[:-len("kernel")] + "weight" if name.endswith(".kernel") \
        else name


def _grad_norms(enc_opt, sr_opt) -> dict:
    """Every leaf's first gradient as the optimizers got it
    (``exp_avg / (1 - beta1)`` after one step), by the reference's
    names."""
    g = judge.leaf_norms(train_driver._grad_from_moments(enc_opt["exp_avg"]))
    g.update({_raw_name(k): v for k, v in judge.leaf_norms(
        train_driver._grad_from_moments(sr_opt["exp_avg"])).items()})
    return g


def _span_window(steps, dev) -> None:
    """Run ``steps`` with the program's spans on and no profiler, whose
    host cost stretches a host-paced step: the span readers read these
    steps' records alone."""
    from fourk_nerf_torch.utils import trace
    trace.reset()
    trace.enable()
    try:
        steps()
        _sync(dev)
    finally:
        trace.disable()


def _program_setup(cfg, seed, dev, params, buffers, weights, poses, imgs, hr):
    """The program's generator, ``JointSteps`` and optimizer states for the
    cell's views and targets."""
    from fourk_nerf_torch import weights as program_weights
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.models import sr_esrnet
    from fourk_nerf_torch.train import optim, sr_trainer, trainer

    cam, dec, t = cfg["camera"], cfg["decoder"], cfg["train"]
    mod = program.model_module(cfg)
    mcfg = program.model_config(cfg)
    with torch.device(dev):
        sr = sr_esrnet.SFTNet(scale=dec["scale"], num_feat=dec["num_feat"],
                              num_block=dec["num_block"],
                              num_grow_ch=dec["num_grow_ch"],
                              num_cond=dec["num_cond"])
    sr.load_state_dict(weights)
    n = len(poses)
    K = inputs.intrinsics(cam)
    data_dict = {"i_train": list(range(n)),
                 "HW": np.array([[cam["H"], cam["W"]]] * n),
                 "Ks": np.stack([K] * n), "poses": np.stack(poses),
                 "images": imgs}
    pcfg = ConfigDict(data=dict(ndc=bool(cam.get("ndc")), inverse_y=False,
                                flip_x=False, flip_y=False))
    cfg_train = ConfigDict(t)
    rk = {"near": cam.get("near", 0.0), "far": cam.get("far", 1.0),
          "bg": cam["bg"], "rand_bkgd": bool(t["rand_bkgd"]),
          "stepsize": cfg["model"]["stepsize"]}
    rk["ndc_planes"] = mod.plane_aligned_ok(mcfg, rk["stepsize"],
                                            bool(cam.get("ndc")))
    flat, _ = trainer.gather_training_rays(
        pcfg, sr_trainer._force_image_sampler(cfg_train), data_dict, dev)
    steps = sr_trainer.JointSteps(
        mod, cfg_train, ConfigDict({"num_cond": dec["num_cond"]}),
        render_kwargs=rk, flat=flat, hr=hr,
        w2c=torch.zeros((n, 3, 3), device=dev), sr_model=sr,
        patch=t["N_patch"], sr_ratio=dec["scale"], seed=int(seed))
    steps.rebuild(mcfg, params, buffers)
    return {"steps": steps, "sr": sr, "enc_opt": optim.init_state(params),
            "sr_opt": optim.init_state(
                {"srnet": program_weights.sftnet_params(sr)})}


def run(ctx) -> dict:
    """One run of a joint cell; returns the run's record."""
    from fourk_nerf_torch.train import sr_trainer

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    if set(tr) - KEYS:
        raise ValueError(f"a joint mix takes no {sorted(set(tr) - KEYS)}")
    if not hasattr(sr_trainer, "JointSteps"):
        raise RuntimeError("the program has no sr_trainer.JointSteps: the "
                           "joint loop's steps cannot be driven")
    cam, dec, t = cfg["camera"], cfg["decoder"], cfg["train"]
    poses = inputs.views(tr["views"], cfg["data"]["train_views"], seed)
    imgs = inputs.images(len(poses), cam, seed)
    hr = hr_images(len(poses), cam, dec["scale"], seed, dev)
    params, buffers = inputs.scene(cfg, seed, dev)
    weights = inputs.decoder(cfg, seed, dev)
    p0, w0 = train_driver._clone(params), train_driver._clone(weights)
    P = _program_setup(cfg, seed, dev, params, buffers, weights, poses, imgs,
                       hr)
    steps, enc_opt, sr_opt = P["steps"], P["enc_opt"], P["sr_opt"]
    start = tr["start_step"]
    since0 = sr_trainer.steps_since_reset_at(t["pg_scale"], start - 1)

    def call(i, drawn=None):
        return steps(start + i, since0 + i, params, buffers, enc_opt, sr_opt,
                     drawn=drawn)

    judged = {"draws": [], "losses": []}
    for i in range(JUDGED_STEPS):
        d = steps.draw(start + i, params, buffers)
        loss, _, _ = call(i, d)
        judged["draws"].append({k: d[k] for k in ("patch", "origin", "path")})
        judged["losses"].append(float(loss))
        if i == 0:
            judged["grad_norms"] = _grad_norms(enc_opt, sr_opt)
    judged["change_norms"] = judge.leaf_norms(train_driver._sub(params, p0))
    judged["change_norms"].update(judge.leaf_norms(
        {"srnet": train_driver._sub(P["sr"].state_dict(), w0)}))
    ctx.check_modules("set-up")
    _sync(dev)
    rec = {"setup_s": time.perf_counter() - ctx.t0, "config": cfg,
           "paths": sorted({d["path"] for d in judged["draws"]})}

    i = JUDGED_STEPS
    before = program.launches()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while time.perf_counter() < deadline:
        call(i)
        i += 1
    _sync(dev)
    rec.update(window_s=time.perf_counter() - t_start,
               steps=i - JUDGED_STEPS)
    launched = {k: v - before[k] for k, v in program.launches().items()
                if v != before[k]}
    ctx.log(f"steps {rec['steps']} in {rec['window_s']:.6f} s on the "
            f"{'/'.join(rec['paths'])} path; kernel launches in them "
            f"{launched}")
    if ctx.trace:
        def profiled():
            nonlocal i
            for _ in range(PROFILED_STEPS):
                call(i)
                i += 1

        rec["profile"] = timing.profile(profiled, lambda: _sync(dev))
        _span_window(profiled, dev)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    del P, steps, enc_opt, sr_opt, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refd = reference_steps(cfg, tr, dev, p0, w0, buffers, poses, imgs, hr,
                           [d["patch"] for d in judged["draws"]])
    if "faults" in refd:
        ctx.log("; ".join(refd["faults"]))
        rec["numbers"] = {k: float("inf") for k in judge.limits(ctx.workload)}
    else:
        rec["counts"] = refd["counts"]
        ctx.log(f"samples a judged step: {refd['per_step']}")
        worst = {}
        rec["numbers"] = judge.train_numbers(judged, refd, worst)
        ctx.log(f"worst leaves {worst}")
    rec["attempted"] = rec["steps"]
    return rec


def reference_steps(cfg, tr, dev, p0, w0, buffers, poses, imgs, hr, patches,
                    conv_rnd=C.identity) -> dict:
    """The reference's first three steps from ``p0`` (the encoder) and
    ``w0`` (the generator) on the program's patches ``(view, row, col)``:
    ``losses``, ``grads`` and ``grad_norms`` (step 1), ``params`` and
    ``change_norms`` (after step 3), ``counts`` and ``per_step`` samples;
    or ``faults`` when a patch does not lie inside its view."""
    cam, dec, t = cfg["camera"], cfg["decoder"], cfg["train"]
    H, W, p, s = cam["H"], cam["W"], t["N_patch"], dec["scale"]
    V = len(poses)
    faults = [f"patch {i} {pt} is not a {p}x{p} patch of one of {V} "
              f"{H}x{W} views" for i, pt in enumerate(patches)
              if not (0 <= pt[0] < V and 0 <= pt[1] <= H - p
                      and 0 <= pt[2] <= W - p)]
    if faults:
        return {"faults": faults}
    K = inputs.intrinsics(cam)
    params = {**train_driver._clone(p0), "srnet": train_driver._clone(w0)}
    opt = ref_train.adam_init(params)
    losses, per_step, out = [], [], {}
    with C.full_fp32():
        for i, (v, r, c) in enumerate(patches):
            gs = tr["start_step"] + i
            sch = train_driver.schedule(t, gs)
            prior = [b for b in t["pg_scale"] if b <= gs - 1]
            lrs = ref_joint.group_lrs(t, gs - 1 - (max(prior) if prior
                                                   else 0))
            rays = [x.reshape(H, W, 3)[r:r + p, c:c + p].reshape(-1, 3)
                    for x in C.view_rays(cam, K, poses[v], dev)]
            rgb = torch.as_tensor(imgs[v][r:r + p, c:c + p],
                                  device=dev).reshape(-1, 3)
            rgb_hr = hr[v, r * s:(r + p) * s, c * s:(c + p) * s]
            loss, grads, cnt = ref_joint.step(
                cfg, params, buffers, opt, (*rays, rgb, rgb_hr), lrs,
                apply_tv=sch["apply_tv"], tv_dense=sch["tv_dense"],
                n_views=V, conv_rnd=conv_rnd)
            losses.append(loss)
            per_step.append(cnt)
            if i == 0:
                out["grads"] = grads
                out["grad_norms"] = {k: float(torch.linalg.vector_norm(
                    g.double())) for k, g in grads.items()}
    out["losses"], out["params"] = losses, params
    out["change_norms"] = judge.leaf_norms(
        train_driver._sub(params, {**p0, "srnet": w0}))
    out["counts"] = {
        "valid_per_step": float(np.mean([c["valid"] for c in per_step])),
        "weighted_per_step": float(np.mean([c["weighted"]
                                            for c in per_step]))}
    out["per_step"] = per_step
    return out
