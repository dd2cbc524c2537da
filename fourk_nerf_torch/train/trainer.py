"""Encoder training and evaluation rendering.

Training (the JAX package's ``train/trainer.py`` for the NDC DirectMPIGO,
after frozoul/4K-NeRF run.py:335-633): :func:`train` fits the fine stage
of a forward-facing scene from its ``data_dict``. :func:`scene_rep_reconstruction`
is the loop: progressive grid scaling with an optimizer reset, the
act_shift decay, occupancy renewal, dense-then-sparse TV, an eval render at
``i_val`` with a best-PSNR save, periodic background saves, the final save,
and resume. Rays of every training view live on the device; the batch
stream is the JAX package's (numpy ``default_rng((seed, epoch))``, indexed
by step), so the same run draws the same rays in both packages and a
resumed run draws what the unbroken one would. :class:`TrainStep` is one
step: autograd of the forward and the losses, the TV gradients, MaskedAdam
in place. Other model families and the coarse stage raise up front.

Evaluation (:func:`render_viewpoints`): full frames of a trained model for
a list of poses, with PSNR / SSIM against ground truth when it is given. A
frame goes through the family's kernel where the model fits it:
``cuda_sweep.render_frame_cuda`` for a plane-aligned NDC DirectMPIGO,
``cuda_box.render_frame_box_cuda`` for a dense DirectVoxGO with its mask at
grid resolution. With ground truth (published metrics) the kernels run
their float32 path, without it their bf16 path. Any other model takes the
chunked ``forward`` of its module. Which path a model takes is decided from
its configuration before the first frame; a kernel that fails raises, it is
never replaced by another path.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time

import numpy as np
import torch

from fourk_nerf_torch import weights
from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import dmpigo, dvgo
from fourk_nerf_torch.ops import cuda_box, cuda_sweep, rays as ray_ops
from fourk_nerf_torch.train import checkpoints, losses, optim
from fourk_nerf_torch.utils import metrics, stats as stats_mod


@dataclasses.dataclass(frozen=True)
class DataFlags:
    """The camera conventions of a dataset (the ``data`` section of the JAX
    package's configs): NDC rays, inverse-y cameras, pixel flips."""

    ndc: bool = False
    inverse_y: bool = False
    flip_x: bool = False
    flip_y: bool = False

    @classmethod
    def from_config(cls, data_cfg) -> "DataFlags":
        return cls(ndc=bool(data_cfg.ndc), inverse_y=bool(data_cfg.inverse_y),
                   flip_x=bool(data_cfg.flip_x), flip_y=bool(data_cfg.flip_y))


def cfg_box_ok(model_cfg) -> bool:
    """True when the bounded-scene sweep can serve this model: dense grids,
    explicit rgb."""
    return (getattr(model_cfg, "density_type", "") == "DenseGrid"
            and getattr(model_cfg, "k0_type", "") == "DenseGrid"
            and not getattr(model_cfg, "rgbnet_full_implicit", False))


def frame_path(model_mod, model_cfg, params, buffers, data: DataFlags,
               stepsize: float) -> str:
    """Which renderer serves this model: ``"sweep"`` (the NDC plane-sweep
    kernel), ``"box"`` (the bounded-scene kernel) or ``"chunked"`` (the
    module's ``forward`` in ray chunks)."""
    if (model_mod is dmpigo and "rgbnet" in params
            and dmpigo.plane_aligned_ok(model_cfg, stepsize, data.ndc)):
        return "sweep"
    if (model_mod is dvgo and cfg_box_ok(model_cfg) and not data.ndc
            and tuple(buffers["mask_cache"].shape)
            == tuple(model_cfg.world_size)):
        return "box"
    return "chunked"


def render_viewpoints(model_mod, model_cfg, params, buffers, render_poses,
                      HW, Ks, *, data: DataFlags, render_kwargs: dict,
                      gt_imgs=None, chunk: int = 8192, eval_ssim: bool = True,
                      render_factor: int = 0,
                      render_video_flipy: bool = False,
                      render_video_rot90: int = 0, verbose: bool = True,
                      device=None) -> dict:
    """Render every pose and, with ``gt_imgs``, score the frames.

    ``model_mod`` is the model's module (``models.dmpigo`` or
    ``models.dvgo``); ``render_kwargs`` holds ``stepsize``, ``bg`` and, for
    bounded scenes, ``near`` and ``far``. ``render_factor`` divides the
    resolution and the intrinsics for previews and skips the metrics;
    ``render_video_flipy`` / ``render_video_rot90`` flip or rotate the
    finished frames. Returns ``rgbs [N,H,W,3]``, ``rgb_features``,
    ``depths [N,H,W]``, ``bgmaps`` as tensors on the device, the per-frame
    ``psnrs`` / ``ssims`` and ``frame_times`` (seconds, host clock), and the
    ``path`` the frames took."""
    dev = resolve_device(device)
    HW = np.asarray(HW)
    Ks = np.asarray(Ks, dtype=np.float32)
    if render_factor:
        HW = (HW.astype(np.float64) / render_factor).astype(int)
        Ks = Ks.copy()
        Ks[:, :2, :3] = Ks[:, :2, :3] / render_factor
        gt_imgs = None  # previews are not scored
    rk = dict(render_kwargs)
    rk.pop("rand_bkgd", None)
    stepsize, bg = rk["stepsize"], rk["bg"]
    flags = dict(inverse_y=data.inverse_y, flip_x=data.flip_x,
                 flip_y=data.flip_y)
    # published metrics are computed in float32; bf16 is the mode of
    # metric-free rendering (videos, previews)
    use_bf16 = gt_imgs is None
    path = frame_path(model_mod, model_cfg, params, buffers, data, stepsize)
    if path == "sweep":
        packed = cuda_sweep.pack_grids_kernel(params, buffers,
                                              use_bf16=use_bf16)
    elif path == "box":
        packed = cuda_box.pack_box_kernel(model_cfg, params, buffers,
                                          use_bf16=use_bf16)

    def chunked_frame(H, W, K_i, c2w):
        ro, rd, vd = (t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
            H, W, K_i, c2w, ndc=data.ndc, device=dev, **flags))
        kw = dict(stepsize=stepsize, bg=bg, render_depth=True)
        if model_mod is dmpigo:
            kw["ndc_planes"] = dmpigo.plane_aligned_ok(model_cfg, stepsize,
                                                       data.ndc)
        else:
            kw.update(near=rk["near"], far=rk["far"])
        outs = [model_mod.forward(model_cfg, params, buffers, ro[s:s + chunk],
                                  rd[s:s + chunk], vd[s:s + chunk], **kw)
                for s in range(0, ro.shape[0], chunk)]
        return {k: torch.cat([o[k] for o in outs]).reshape(
                    H, W, *outs[0][k].shape[1:])
                for k in ("rgb_marched", "rgb_feature", "depth",
                          "alphainv_last")}

    rgbs, feats, depths, bgmaps = [], [], [], []
    psnrs, ssims, frame_times = [], [], []
    for fi, pose in enumerate(render_poses):
        H, W = int(HW[fi][0]), int(HW[fi][1])
        c2w = np.asarray(pose, dtype=np.float32)[:3, :4]
        t0 = time.perf_counter()
        if path == "sweep":
            out = cuda_sweep.render_frame_cuda(
                model_cfg, params, buffers, H, W, Ks[fi], c2w,
                stepsize=stepsize, bg=bg, device=dev, packed=packed, **flags)
        elif path == "box":
            out = cuda_box.render_frame_box_cuda(
                model_cfg, params, buffers, H, W, Ks[fi], c2w,
                stepsize=stepsize, near=rk["near"], bg=bg, device=dev,
                packed=packed, **flags)
        else:
            out = chunked_frame(H, W, Ks[fi], c2w)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        frame_times.append(time.perf_counter() - t0)
        rgbs.append(out["rgb_marched"])
        feats.append(out["rgb_feature"])
        depths.append(out["depth"])
        bgmaps.append(out["alphainv_last"])
        if gt_imgs is not None:
            rgb, gt = out["rgb_marched"].cpu().numpy(), np.asarray(gt_imgs[fi])
            psnrs.append(metrics.psnr(rgb, gt))
            if eval_ssim:
                ssims.append(metrics.rgb_ssim(rgb, gt))
    if verbose and psnrs:
        print(f"render_viewpoints: psnr {np.mean(psnrs):.2f}"
              + (f" ssim {np.mean(ssims):.4f}" if ssims else ""))
    maps = [rgbs, feats, depths, bgmaps]
    if render_video_flipy:
        maps = [[x.flip(0) for x in m] for m in maps]
    if render_video_rot90 != 0:
        k = int(render_video_rot90)
        maps = [[torch.rot90(x, k, (0, 1)) for x in m] for m in maps]
    rgbs, feats, depths, bgmaps = (torch.stack(m) for m in maps)
    return {"rgbs": rgbs, "rgb_features": feats, "depths": depths,
            "bgmaps": bgmaps, "psnrs": psnrs, "ssims": ssims,
            "frame_times": frame_times, "path": path}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "rgb")


def _later(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A item {item}")


def compute_bbox_by_cam_frustrm(cfg, HW, Ks, poses, i_train, near, far,
                                near_clip=None, device=None):
    """The scene box that holds every training camera's frustum between
    ``near`` and ``far`` (frozoul/4K-NeRF run.py:207-254), float64 on the
    host."""
    if cfg.data.get("unbounded_inward", False):
        raise _later("the unbounded-inward box (DirectContractedVoxGO)",
                     "5 (secondary models)")
    dev = resolve_device(device)
    xyz_min = np.full(3, np.inf)
    xyz_max = -xyz_min
    for i in i_train:
        H, W = (int(v) for v in HW[i])
        ro, rd, vd = ray_ops.get_rays_of_a_view(
            H, W, Ks[i], poses[i], ndc=cfg.data.ndc,
            inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y, device=dev)
        step = rd if cfg.data.ndc else vd
        pts = torch.stack([ro + step * near, ro + step * far]).reshape(-1, 3)
        xyz_min = np.minimum(xyz_min, pts.amin(0).cpu().numpy())
        xyz_max = np.maximum(xyz_max, pts.amax(0).cpu().numpy())
    return xyz_min, xyz_max


def gather_training_rays(cfg, cfg_train, data_dict, device=None):
    """The rays and colours of every training view on the device:
    ``flat`` (``[n, 3]`` each for the ``flatten`` sampler, ``[V, H, W, 3]``
    for ``random``) and the per-view ``[H, W, 3]`` lists."""
    sampler = cfg_train.ray_sampler
    if sampler in ("in_maskcache", "patch_box"):
        raise _later(f"the {sampler} sampler", "2 (the bounded run.py path)")
    if sampler in ("patch_simg", "patch_mimg", "patch_inmask"):
        raise _later(f"run.py's {sampler} sampler",
                     "3c (the encoder's patch samplers)")
    if sampler not in ("flatten", "random"):
        raise NotImplementedError(sampler)
    dev = resolve_device(device)
    lists = {k: [] for k in _RAY_KEYS}
    for i in data_dict["i_train"]:
        H, W = (int(v) for v in data_dict["HW"][i])
        ro, rd, vd = ray_ops.get_rays_of_a_view(
            H, W, data_dict["Ks"][i], data_dict["poses"][i], ndc=cfg.data.ndc,
            inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y, device=dev)
        lists["rays_o"].append(ro)
        lists["rays_d"].append(rd)
        lists["viewdirs"].append(vd)
        lists["rgb"].append(torch.as_tensor(
            np.asarray(data_dict["images"][i], dtype=np.float32), device=dev))
    if sampler == "flatten":
        flat = {k: torch.cat([a.reshape(-1, a.shape[-1]) for a in v])
                for k, v in lists.items()}
    else:
        flat = {k: torch.stack(v) for k, v in lists.items()}
    return flat, lists


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device: a pinned
    copy sent with ``non_blocking`` (a pageable one would synchronise)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def make_batch_sampler(sampler: str, flat: dict, n_rand: int, seed: int):
    """``sample(step) -> (kind, indices)`` for the 0-based draw ``step``
    (frozoul/4K-NeRF lib/dvgo.py:761-819). Each epoch's permutation is a
    pure function of ``(seed, epoch)`` and each ``random`` draw of
    ``(seed, step)``, so a resumed run replays the stream."""
    dev = flat["rgb"].device
    if sampler == "flatten":
        n = flat["rgb"].shape[0]
        bpe = max(n // n_rand, 1)  # rollover when top + n_rand > n
        cache = {"epoch": -1, "perm": None}

        def sample(step: int):
            epoch, i = divmod(step, bpe)
            if cache["epoch"] != epoch:
                cache["epoch"] = epoch
                cache["perm"] = _upload(
                    np.random.default_rng((seed, epoch)).permutation(n), dev)
            return "flat", cache["perm"][i * n_rand:(i + 1) * n_rand]

        return sample
    if sampler == "random":
        V, H, W = flat["rgb"].shape[:3]

        def sample(step: int):
            rng = np.random.default_rng((seed, step))
            return "pix", tuple(_upload(rng.integers(0, n, n_rand), dev)
                                for n in (V, H, W))

        return sample
    if sampler in ("in_maskcache", "patch_box"):
        raise _later(f"the {sampler} sampler", "2 (the bounded run.py path)")
    if sampler in ("patch_simg", "patch_mimg", "patch_inmask"):
        raise _later(f"run.py's {sampler} sampler",
                     "3c (the encoder's patch samplers)")
    raise NotImplementedError(sampler)


def gather_batch(flat: dict, kind: str, sel):
    """(rays_o, rays_d, viewdirs, rgb) of one draw of the sampler."""
    if kind == "flat":
        return tuple(flat[k][sel] for k in _RAY_KEYS)
    b, r, c = sel
    return tuple(flat[k][b, r, c] for k in _RAY_KEYS)


def bkgd_noise(seed: int, step: int, n: int, device) -> torch.Tensor:
    """The random background of training step ``step``: ``[n, 3]`` uniform
    noise from a ``torch.Generator`` seeded by ``(seed, step)``, drawn on
    the host (the same numbers on every device) and sent without a wait."""
    state = np.random.SeedSequence((seed, 0x5EED, step)).generate_state(1)
    g = torch.Generator().manual_seed(int(state[0]))
    return _upload(torch.rand((n, 3), generator=g).numpy(),
                   torch.device(device))


def _detached_leaves(tree):
    if isinstance(tree, dict):
        return {k: _detached_leaves(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _flatten(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    return next(it)


class TrainStep:
    """One encoder training step for a fixed model configuration (one
    progressive-scaling phase): the loss and its gradients by autograd,
    the TV gradients added, MaskedAdam applied to the params in place."""

    def __init__(self, model_mod, model_cfg, cfg_train, *,
                 render_kwargs: dict, skip_zero_grad=frozenset()):
        self.model_mod, self.model_cfg = model_mod, model_cfg
        self.cfg_train = cfg_train
        self.skip_zero_grad = frozenset(skip_zero_grad)
        self.fwd_kw = dict(
            stepsize=render_kwargs["stepsize"], bg=render_kwargs["bg"],
            rand_bkgd=bool(render_kwargs.get("rand_bkgd", False)),
            is_train=True,
            ndc_planes=bool(render_kwargs.get("ndc_planes", False)))
        self.weight_tv_density = float(cfg_train.weight_tv_density)
        self.weight_tv_k0 = float(cfg_train.weight_tv_k0)

    def loss_and_grads(self, params, buffers, batch, groups, bg_noise=None):
        """(loss, terms, grads) of one batch; ``grads`` holds the param
        groups named in ``groups``, in the layout of ``params``."""
        rays_o, rays_d, viewdirs, target = batch
        live = {k: _detached_leaves(params[k]) for k in groups}
        out = self.model_mod.forward(
            self.model_cfg, {**params, **live}, buffers, rays_o, rays_d,
            viewdirs, bg_noise=bg_noise, **self.fwd_kw)
        loss, terms = losses.encoder_losses(out, target, self.cfg_train,
                                            rays_o.shape[0])
        leaves = _flatten(live, [])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in terms.items()},
                _unflatten(live, iter(grads)))

    @torch.no_grad()
    def add_tv(self, params, grads, n_rays: int, tv_dense: bool) -> None:
        """Add the TV gradients of the density and k0 grids to ``grads``
        in place (sparse mode: only where the gradient is non-zero)."""
        m = self.model_mod
        if self.weight_tv_density > 0 and "density" in grads:
            grads["density"].add_(m.density_tv_grad(
                self.model_cfg, params, self.weight_tv_density, tv_dense,
                n_rays, grads["density"]))
        if self.weight_tv_k0 > 0 and "k0" in grads:
            grads["k0"].add_(m.k0_tv_grad(
                self.model_cfg, params, self.weight_tv_k0, tv_dense, n_rays,
                grads["k0"]))

    def __call__(self, params, buffers, opt_state, batch, lrs, per_lr,
                 bg_noise, *, apply_tv: bool, tv_dense: bool):
        """One step; updates ``params`` and ``opt_state`` in place and
        returns (loss, psnr) as device scalars."""
        with torch.profiler.record_function("train_step"):
            loss, terms, grads = self.loss_and_grads(params, buffers, batch,
                                                     lrs.keys(), bg_noise)
            if apply_tv:
                self.add_tv(params, grads, batch[0].shape[0], tv_dense)
            optim.apply_updates(params, grads, opt_state, lrs,
                                skip_zero_grad=self.skip_zero_grad,
                                per_lr=per_lr)
            psnr = -10.0 * torch.log10(
                terms["mse"] / max(self.cfg_train.weight_main, 1e-12))
        return loss, psnr



def _periodic_step(path: str, stage: str):
    """The step of a periodic checkpoint ``<stage>_<step>.npz``, else
    None (the last and temporary files do not parse)."""
    name = os.path.basename(path)
    if not (name.startswith(f"{stage}_") and name.endswith(".npz")):
        return None
    tail = name[len(stage) + 1:-len(".npz")]
    return int(tail) if tail.isdigit() else None


def find_reload_path(args, rundir: str, stage: str):
    """The checkpoint a run resumes from: ``--ft_path``, else the stage's
    last checkpoint, else the periodic one with the largest step (by the
    parsed integer: ``fine_1000000`` comes after ``fine_999999``), else
    None. ``--no_reload`` gives None."""
    if getattr(args, "no_reload", False):
        return None
    if getattr(args, "ft_path", ""):
        return args.ft_path
    last = os.path.join(rundir, f"{stage}_last.npz")
    if os.path.isfile(last):
        return last
    steps = {p: _periodic_step(p, stage)
             for p in glob.glob(os.path.join(rundir, f"{stage}_*.npz"))}
    steps = {p: s for p, s in steps.items() if s is not None}
    return max(steps, key=steps.get) if steps else None


def scene_rep_reconstruction(args, cfg, cfg_model, cfg_train, xyz_min,
                             xyz_max, data_dict, stage: str, writer=None,
                             device=None):
    """Train one stage on ``device`` (default ``cuda``). Returns
    (model_mod, model_cfg, params, buffers)."""
    dev = resolve_device(device)
    model_mod = _select_model_mod(cfg)
    if abs(cfg_model.world_bound_scale - 1) > 1e-9:
        xyz_shift = (xyz_max - xyz_min) * (cfg_model.world_bound_scale - 1) / 2
        xyz_min, xyz_max = xyz_min - xyz_shift, xyz_max + xyz_shift
    if cfg_train.pervoxel_lr:
        raise _later("the per-voxel lr (voxel_count_views)",
                     "2 (the bounded run.py path)")
    seed = int(getattr(args, "seed", 777))
    rundir = os.path.join(cfg.basedir, cfg.expname)
    last_ckpt_path = os.path.join(rundir, f"{stage}_last.npz")

    # --- model: new, or reloaded (run.py:280-332) ---------------------------
    model_kwargs = dict(cfg_model)
    num_voxels = model_kwargs.pop("num_voxels")
    if len(cfg_train.pg_scale):
        num_voxels = int(num_voxels / (2 ** len(cfg_train.pg_scale)))
    reload_path = find_reload_path(args, rundir, stage)
    start, opt_state_l, meta_l = 0, None, {}
    if reload_path is None:
        model_cfg = _make_cfg(model_mod, xyz_min, xyz_max, num_voxels,
                              model_kwargs)
        params, buffers = model_mod.init(
            model_cfg, generator=torch.Generator().manual_seed(seed),
            device=dev)
    else:
        print(f"scene_rep_reconstruction ({stage}): reload from {reload_path}")
        if reload_path.endswith(".tar"):  # a reference torch checkpoint
            kwargs_l, p_np, b_np, start = \
                checkpoints.import_torch_encoder_checkpoint(reload_path)
            params, buffers = weights.dmpigo_from_numpy(p_np, b_np, dev)
        else:
            kwargs_l, params, buffers, opt_state_l, start, meta_l = \
                checkpoints.load_checkpoint(reload_path, device=dev)
        model_cfg = model_mod.make_config(**kwargs_l)

    render_kwargs = {
        "near": float(data_dict["near"]), "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "rand_bkgd": bool(cfg.data.rand_bkgd),
        "stepsize": float(cfg_model.stepsize),
    }
    render_kwargs["ndc_planes"] = dmpigo.plane_aligned_ok(
        model_cfg, render_kwargs["stepsize"], cfg.data.ndc)
    data_flags = DataFlags.from_config(cfg.data)

    # --- rays and sampler ----------------------------------------------------
    flat, ray_lists = gather_training_rays(cfg, cfg_train, data_dict, dev)
    sample_batch = make_batch_sampler(cfg_train.ray_sampler, flat,
                                      cfg_train.N_rand, seed)
    if cfg_train.get("maskout_lt_nviews", 0) > 0:
        buffers = dmpigo.update_occupancy_cache_lt_nviews(
            model_cfg, buffers, ray_lists["rays_o"], ray_lists["rays_d"],
            cfg_model.stepsize, cfg_train.maskout_lt_nviews)
    del ray_lists

    # --- optimizer -------------------------------------------------------------
    base_lrs = optim.build_group_lrs(cfg_train, params)
    skip_zero = frozenset(cfg_train.skip_zero_grad_fields)
    opt_state = optim.init_state(params)
    if not getattr(args, "no_reload_optimizer", False):
        opt_state, restored = optim.restore_state(opt_state_l, opt_state)
        if restored:
            print(f"scene_rep_reconstruction ({stage}): restored optimizer "
                  "state")
    del opt_state_l
    train_step = TrainStep(model_mod, model_cfg, cfg_train,
                           render_kwargs=render_kwargs,
                           skip_zero_grad=skip_zero)

    # the lr-decay clock restarts at each pg_scale boundary: take it from
    # the checkpoint, where it is kept
    if "steps_since_reset" in meta_l:
        steps_since_reset = int(meta_l["steps_since_reset"])
    else:
        prior = [b for b in cfg_train.pg_scale if b <= start]
        steps_since_reset = start - (max(prior) if prior else 0)
    collector = stats_mod.Collector()
    best_val_psnr = -1.0
    time0 = time.time()
    saver = checkpoints.AsyncSaver()
    try:
        for global_step in range(1 + start, 1 + cfg_train.N_iters):
            if (global_step + 500) % 1000 == 0:  # run.py:461-462
                buffers = model_mod.update_occupancy_cache(model_cfg, params,
                                                           buffers)
            if global_step in cfg_train.pg_scale:  # run.py:465-476
                n_rest = (len(cfg_train.pg_scale)
                          - cfg_train.pg_scale.index(global_step) - 1)
                cur_voxels = int(cfg_model.num_voxels / (2 ** n_rest))
                opt_state = None  # the old moments go before the grids grow
                model_cfg, params, buffers = dmpigo.scale_volume_grid(
                    model_cfg, params, buffers, cur_voxels,
                    model_cfg.mpi_depth)
                buffers = dmpigo.decay_act_shift(buffers,
                                                 cfg_train.decay_after_scale)
                opt_state = optim.init_state(params)
                steps_since_reset = 0
                train_step = TrainStep(model_mod, model_cfg, cfg_train,
                                       render_kwargs=render_kwargs,
                                       skip_zero_grad=skip_zero)

            kind, sel = sample_batch(global_step - 1)
            batch = gather_batch(flat, kind, sel)
            lrs = {k: optim.group_lr(v, steps_since_reset,
                                     cfg_train.lrate_decay)
                   for k, v in base_lrs.items()}
            noise = (bkgd_noise(seed, global_step, batch[0].shape[0], dev)
                     if render_kwargs["rand_bkgd"] else None)
            apply_tv = (cfg_train.tv_after < global_step < cfg_train.tv_before
                        and global_step % cfg_train.tv_every == 0)
            loss, psnr = train_step(
                params, buffers, opt_state, batch, lrs, None, noise,
                apply_tv=bool(apply_tv),
                tv_dense=bool(global_step < cfg_train.tv_dense_before))
            steps_since_reset += 1
            collector.report("train/loss", stats_mod.moments(loss))
            collector.report("train/psnr", stats_mod.moments(psnr))

            if args.i_print and global_step % args.i_print == 0:
                print(f"scene_rep_reconstruction ({stage}): iter "
                      f"{global_step:6d} / "
                      f"Loss: {collector.mean('train/loss'):.9f} / "
                      f"PSNR: {collector.mean('train/psnr'):5.2f} / "
                      f"Eps: {time.time() - time0:.0f}s", flush=True)
                if writer is not None:
                    for name, st in collector.as_dict().items():
                        writer.scalar(name, st.mean, global_step)
                collector.reset()

            i_val = data_dict["i_val"]
            if args.i_val and global_step % args.i_val == 0 and len(i_val):
                res = render_viewpoints(
                    model_mod, model_cfg, params, buffers,
                    data_dict["poses"][i_val], data_dict["HW"][i_val],
                    data_dict["Ks"][i_val], data=data_flags,
                    render_kwargs=render_kwargs,
                    gt_imgs=[np.asarray(data_dict["images"][i])
                             for i in i_val], device=dev)
                val_psnr = float(np.mean(res["psnrs"]))
                if writer is not None:
                    writer.scalar("val/psnr", val_psnr, global_step)
                    if res["ssims"]:
                        writer.scalar("val/ssim", float(np.mean(res["ssims"])),
                                      global_step)
                if val_psnr > best_val_psnr:
                    best_val_psnr = val_psnr
                    checkpoints.save_checkpoint(
                        os.path.join(rundir, "best_psnr.npz"),
                        model_mod.get_kwargs(model_cfg), params, buffers,
                        global_step=global_step, saver=saver)

            if args.i_weights and global_step % args.i_weights == 0:
                checkpoints.save_checkpoint(
                    os.path.join(rundir, f"{stage}_{global_step:06d}.npz"),
                    model_mod.get_kwargs(model_cfg), params, buffers,
                    opt_state, global_step,
                    extra_meta={"steps_since_reset": steps_since_reset},
                    saver=saver)

        saver.wait_for_pending_saves()
        if cfg_train.N_iters > 0:
            checkpoints.save_checkpoint(
                last_ckpt_path, model_mod.get_kwargs(model_cfg), params,
                buffers, opt_state, cfg_train.N_iters,
                extra_meta={"steps_since_reset": steps_since_reset})
            print(f"scene_rep_reconstruction ({stage}): saved checkpoint at "
                  f"{last_ckpt_path}")
    finally:
        saver.close()
    return model_mod, model_cfg, params, buffers


def _select_model_mod(cfg):
    """The model family of a config (run.py:286-313): DirectMPIGO for NDC
    scenes. The families whose training forms are not ported raise."""
    if cfg.data.ndc:
        if cfg.fine_model_and_render.get("mode_type") == "adain_vq":
            raise _later("DirectQVGO (mode_type adain_vq) training",
                         "5 (secondary models)")
        return dmpigo
    if cfg.data.get("unbounded_inward", False):
        raise _later("DirectContractedVoxGO training", "5 (secondary models)")
    raise _later("DirectVoxGO training", "2 (the bounded run.py path)")


def _make_cfg(model_mod, xyz_min, xyz_max, num_voxels, model_kwargs):
    kw = dict(model_kwargs)
    return model_mod.make_config(xyz_min=xyz_min, xyz_max=xyz_max,
                                 num_voxels=num_voxels,
                                 mpi_depth=kw.pop("mpi_depth"), **kw)


def train(args, cfg, data_dict, writer=None, device=None):
    """Fit a scene (run.py:636-685): the fine stage of a forward-facing
    scene on ``device`` (default ``cuda``). Returns (model_mod, model_cfg,
    params, buffers)."""
    _select_model_mod(cfg)
    if cfg.coarse_train.N_iters > 0:
        raise _later("the coarse stage", "2 (the bounded run.py path)")
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    xyz_min, xyz_max = compute_bbox_by_cam_frustrm(
        cfg, data_dict["HW"], data_dict["Ks"], data_dict["poses"],
        data_dict["i_train"], data_dict["near"], data_dict["far"],
        near_clip=data_dict.get("near_clip"), device=device)
    return scene_rep_reconstruction(
        args, cfg, cfg.fine_model_and_render, cfg.fine_train, xyz_min,
        xyz_max, data_dict, stage="fine", writer=writer, device=device)
