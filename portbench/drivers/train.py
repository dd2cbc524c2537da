"""Training cells: the encoder's fitting steps, each the loop's own
sequence (``trainer.scene_rep_reconstruction``): the sampler's draw,
``trainer.gather_batch``, the random background, ``TrainStep.__call__``
with the lr of the published schedule at the window's global step.

Set-up builds one training step with its parameters and MaskedAdam
state and drives it through its first three steps on the window's own
call; the reference follows those three from the same initial
parameters and batches once the window has closed. The window then runs
on the same object, unsynced, and syncs the device at its end.

A training mix holds (and may hold only) ``kind``, ``views`` (the path
its training cameras are set on) and ``start_step`` (the global step of
the first judged step, which sets the lr, the TV switches and the
background noise).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, judge, program, timing
from portbench.reference import common as C
from portbench.reference import train as ref_train

JUDGED_STEPS = 3
PART_STEPS = 16      # traced: steps split into forward + backward and update
PROFILED_STEPS = 12  # traced: steps under the profiler
KEYS = {"kind", "views", "start_step"}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _program_setup(cfg, seed, dev, params, buffers, poses, imgs):
    """The program's rays, sampler, step and MaskedAdam state for the
    cell's views."""
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.train import optim, trainer

    cam, t = cfg["camera"], cfg["train"]
    mod = program.model_module(cfg)
    mcfg = program.model_config(cfg)
    n = len(poses)
    K = inputs.intrinsics(cam)
    data_dict = {"i_train": list(range(n)),
                 "HW": np.array([[cam["H"], cam["W"]]] * n),
                 "Ks": np.stack([K] * n), "poses": np.stack(poses),
                 "images": imgs}
    pcfg = ConfigDict(data=dict(ndc=bool(cam.get("ndc")), inverse_y=False,
                                flip_x=False, flip_y=False))
    cfg_train = ConfigDict(t)
    render_kwargs = {"near": cam.get("near", 0.0), "far": cam.get("far", 1.0),
                     "bg": cam["bg"], "rand_bkgd": bool(t["rand_bkgd"]),
                     "stepsize": cfg["model"]["stepsize"]}
    if hasattr(mod, "plane_aligned_ok"):  # a family on NDC planes
        render_kwargs["ndc_planes"] = mod.plane_aligned_ok(
            mcfg, render_kwargs["stepsize"], bool(cam.get("ndc")))
    flat, _ = trainer.gather_training_rays(
        pcfg, cfg_train, data_dict, dev, model=(mod, mcfg, buffers),
        render_kwargs=render_kwargs)
    sampler = trainer.make_batch_sampler(t["ray_sampler"], flat, t["N_rand"],
                                         int(seed))
    step = trainer.TrainStep(mod, mcfg, cfg_train,
                             render_kwargs=render_kwargs,
                             skip_zero_grad=frozenset(
                                 t["skip_zero_grad_fields"]))
    return {"flat": flat, "sampler": sampler, "step": step,
            "opt": optim.init_state(params),
            "lrs": optim.build_group_lrs(cfg_train, params),
            "patch": getattr(sampler, "patch", 0)}


def schedule(t: dict, global_step: int) -> dict:
    """The loop's per-step switches at ``global_step``: steps since the
    last ``pg_scale`` boundary, TV on or off, dense or sparse TV."""
    prior = [b for b in t["pg_scale"] if b <= global_step]
    return {"since_reset": (global_step - max(prior) if prior
                            else global_step - 1),
            "apply_tv": bool(t["tv_after"] < global_step < t["tv_before"]
                             and global_step % t["tv_every"] == 0),
            "tv_dense": bool(global_step < t["tv_dense_before"])}


def run(ctx) -> dict:
    """One run of a training cell; returns the run's record."""
    from fourk_nerf_torch.train import optim, trainer

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    if set(tr) - KEYS:
        raise ValueError(f"a training mix takes no {sorted(set(tr) - KEYS)}")
    cam, t = cfg["camera"], cfg["train"]
    poses = inputs.views(tr["views"], cfg["data"]["train_views"], seed)
    imgs = inputs.images(len(poses), cam, seed)
    params, buffers = inputs.scene(cfg, seed, dev)
    p0 = _clone(params)
    P = _program_setup(cfg, seed, dev, params, buffers, poses, imgs)
    start = tr["start_step"]
    n_rand = t["N_rand"]

    def draw(i):
        gs = start + i
        kind, sel = P["sampler"](gs - 1)
        batch = trainer.gather_batch(P["flat"], kind, sel, P["patch"])
        return gs, sel, batch

    def call(gs, batch):
        sch = schedule(t, gs)
        lrs = {k: optim.group_lr(v, sch["since_reset"], t["lrate_decay"])
               for k, v in P["lrs"].items()}
        noise = (inputs.bkgd_noise(seed, gs, n_rand, dev)
                 if t["rand_bkgd"] else None)
        return P["step"](params, buffers, P["opt"], batch, lrs, None, noise,
                         apply_tv=sch["apply_tv"], tv_dense=sch["tv_dense"])

    judged = {"sel": [], "losses": []}
    for i in range(JUDGED_STEPS):
        gs, sel, batch = draw(i)
        loss, _ = call(gs, batch)
        judged["sel"].append(sel.detach().clone())
        judged["losses"].append(float(loss))
        if i == 0:
            judged["grad_norms"] = judge.leaf_norms(
                _grad_from_moments(P["opt"]["exp_avg"]))
    judged["change_norms"] = judge.leaf_norms(_sub(params, p0))
    ctx.check_modules("set-up")
    _sync(dev)
    rec = {"setup_s": time.perf_counter() - ctx.t0, "config": cfg}

    ev = {"batch_ms": []} if ctx.trace else None
    i = JUDGED_STEPS
    before = program.launches()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while time.perf_counter() < deadline:
        if ev is None:
            gs, _, batch = draw(i)
        else:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            gs, _, batch = draw(i)
            b.record()
            ev["batch_ms"].append((a, b))
        call(gs, batch)
        i += 1
    _sync(dev)
    rec.update(window_s=time.perf_counter() - t_start,
               steps=i - JUDGED_STEPS)
    launched = {k: v - before[k] for k, v in program.launches().items()
                if v != before[k]}
    ctx.log(f"steps {rec['steps']} in {rec['window_s']:.6f} s; kernel "
            f"launches in them {launched}")
    if ev is not None:
        ev["batch_ms"] = [a.elapsed_time(b) for a, b in ev["batch_ms"]]
        ev["fwd_bwd_ms"], ev["step_call_ms"] = [], []
        for _ in range(PART_STEPS):
            gs, _, batch = draw(i)
            noise = (inputs.bkgd_noise(seed, gs, n_rand, dev)
                     if t["rand_bkgd"] else None)
            e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            e[0].record()
            P["step"].loss_and_grads(params, buffers, batch, P["lrs"].keys(),
                                     noise)
            e[1].record()
            e[2].record()
            call(gs, batch)
            e[3].record()
            _sync(dev)
            ev["fwd_bwd_ms"].append(e[0].elapsed_time(e[1]))
            ev["step_call_ms"].append(e[2].elapsed_time(e[3]))
            i += 1
        rec["events"] = ev

        def steps():
            nonlocal i
            for _ in range(PROFILED_STEPS):
                gs, _, batch = draw(i)
                call(gs, batch)
                i += 1

        rec["profile"] = timing.profile(steps, lambda: _sync(dev))
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    n_rows = int(P["flat"]["rgb"].shape[0])
    del P, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refd = reference_steps(cfg, tr, seed, dev, p0, buffers, poses, imgs,
                           judged["sel"], n_rows)
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


def _grad_from_moments(m):
    """The first step's gradient as the optimizer got it:
    ``exp_avg / (1 - beta1)`` after one step."""
    if isinstance(m, dict):
        return {k: _grad_from_moments(v) for k, v in m.items()}
    return m / 0.1


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a.detach() - b


def reference_rays(cfg, poses, imgs, dev, buffers):
    """The reference's table of training rays, view by view in row order:
    every ray (``flatten``), or those that meet the occupancy mask
    (``in_maskcache``)."""
    cam = cfg["camera"]
    K = inputs.intrinsics(cam)
    cols = {"ro": [], "rd": [], "vd": [], "rgb": []}
    for c2w, img in zip(poses, imgs):
        ro, rd, vd = C.view_rays(cam, K, c2w, dev)
        rgb = torch.as_tensor(img, device=dev).reshape(-1, 3)
        if cfg["train"]["ray_sampler"] == "in_maskcache":
            hit = C.family(cfg["family"]).hit_rays(cfg["model"], buffers, ro,
                                                   rd, cam["near"])
            ro, rd, vd, rgb = ro[hit], rd[hit], vd[hit], rgb[hit]
        for k, v in zip(cols, (ro, rd, vd, rgb)):
            cols[k].append(v)
    return {k: torch.cat(v) for k, v in cols.items()}


def reference_steps(cfg, tr, seed, dev, p0, buffers, poses, imgs, sels,
                    n_rows, mm=C.matmul) -> dict:
    """The reference's first three steps from ``p0`` on the program's
    draws ``sels``: ``losses``, ``grad_norms`` (step 1), ``change_norms``
    (after step 3), ``counts`` and ``per_step`` samples; or ``faults``
    when the program's ray table or a draw (not ``N_rand`` different rows
    of the table) cannot be followed."""
    cam, t, m = cfg["camera"], cfg["train"], cfg["model"]
    rays = reference_rays(cfg, poses, imgs, dev, buffers)
    n = rays["rgb"].shape[0]
    faults = []
    if n != n_rows:
        faults.append(f"the program's ray table has {n_rows} rows, the "
                      f"reference's {n}")
    for i, sel in enumerate(sels):
        if (sel.numel() != t["N_rand"] or int(sel.min()) < 0
                or int(sel.max()) >= n
                or torch.unique(sel).numel() != sel.numel()):
            faults.append(f"draw {i} is not {t['N_rand']} different rows "
                          f"of {n}")
    if faults:
        return {"faults": faults}
    params = _clone(p0)
    opt = ref_train.adam_init(params)
    base = {k[len("lrate_"):]: v for k, v in t.items()
            if k.startswith("lrate_") and v and v > 0
            and k[len("lrate_"):] in params}
    losses, per_step = [], []
    out = {}
    with C.full_fp32():
        for i, sel in enumerate(sels):
            sel = sel.to(dev).long()
            gs = tr["start_step"] + i
            sch = schedule(t, gs)
            lrs = {k: ref_train.group_lr(v, sch["since_reset"],
                                         t["lrate_decay"])
                   for k, v in base.items()}
            bg = (inputs.bkgd_noise(seed, gs, t["N_rand"], dev)
                  if t["rand_bkgd"] else cam["bg"])
            batch = tuple(rays[k][sel] for k in ("ro", "rd", "vd", "rgb"))
            loss, grads, cnt = ref_train.step(
                cfg["family"], m, t, params, buffers, opt, batch, lrs,
                bg=bg, near=cam.get("near", 0.0), apply_tv=sch["apply_tv"],
                tv_dense=sch["tv_dense"], mm=mm)
            losses.append(loss)
            per_step.append(cnt)
            if i == 0:
                out["grad_norms"] = {k: float(torch.linalg.vector_norm(
                    v.double())) for k, v in grads.items()}
    out["losses"] = losses
    out["change_norms"] = judge.leaf_norms(_sub(params, p0))
    out["counts"] = {
        "valid_per_step": float(np.mean([c["valid"] for c in per_step])),
        "weighted_per_step": float(np.mean([c["weighted"]
                                            for c in per_step]))}
    out["per_step"] = per_step
    return out
