"""Encoder training and evaluation rendering.

Training (the JAX package's ``train/trainer.py``, after frozoul/4K-NeRF
run.py:335-685): :func:`train` fits a scene from its ``data_dict``: with
a coarse stage, the coarse model, the box tightened to its geometry, then
the fine stage on its mask (a bounded scene's DirectVoxGO); without, the
fine stage alone (a forward-facing scene's NDC DirectMPIGO, or an
unbounded inward-facing scene's DirectContractedVoxGO on the cube of its
cameras' near-clip points, with the near-clip and distortion losses).
:func:`scene_rep_reconstruction` is the loop of one stage: the
near-camera mask-out, the per-voxel lr from the views' counts,
progressive grid scaling with an optimizer reset, the act_shift decay,
occupancy renewal, dense-then-sparse TV, an eval render at ``i_val`` with
a best-PSNR save, periodic background saves, the final save, and resume.
Rays of every training view live on the device; the batch stream is the
JAX package's (numpy ``default_rng((seed, epoch))``, indexed by step), so
the same run draws the same rays, pixels or patches in both packages and
a resumed run draws what the unbroken one would. :class:`TrainStep` is
one step: autograd of the forward and the losses, the TV gradients
(TensoRF factors': the autograd gradient of their TV loss), MaskedAdam in
place, and a DirectQVGO's EMA codebook put in the buffers. The
``patch_box`` sampler trains a DirectVoxGO on pixel patches through the
differentiable slab sweep (``box_sweep.sweep_rays_train_box``), with a
static plan per view (:func:`compute_box_plans`, renewed at each
``pg_scale`` step); every other model, and a stage some view of which has
no dominant axis or too wide a window, trains on the same patches through
its gather forward, as in the JAX package, and says so (the stage's last
line counts its steps by route). A DirectQVGO
(``mode_type`` adain_vq) run with a ``pg_scale``, which the JAX package
cannot scale, is refused up front.

Evaluation (:func:`render_viewpoints`): full frames of a trained model for
a list of poses, with PSNR / SSIM against ground truth when it is given. A
frame goes through the family's kernel where the model fits it:
``cuda_sweep.render_frame_cuda`` for a plane-aligned NDC DirectMPIGO with
dense grids, ``cuda_box.render_frame_box_cuda`` for a dense DirectVoxGO
with its mask at grid resolution. With ground truth (published metrics)
the kernels run their float32 path, without it their bf16 path. Any other
model (a DirectContractedVoxGO or a DirectQVGO always, a model with a
TensoRF grid, a DirectMPIGO with ``dim_rend > 3``) takes the chunked
``forward`` of its module.
Which path a model takes is decided from its configuration before the
first frame; a kernel that fails raises, it is never replaced by another
path.
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
from fourk_nerf_torch.models import common, dcvgo, dmpigo, dvgo, dvqgo, \
    model_module
from fourk_nerf_torch.ops import box_sweep, cuda_box, cuda_sweep, \
    grid_sample, rays as ray_ops, render
from fourk_nerf_torch.train import checkpoints, losses, optim
from fourk_nerf_torch.utils import metrics, stats as stats_mod, trace


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
    return dense_grids(model_cfg) and not getattr(
        model_cfg, "rgbnet_full_implicit", False)


def dense_grids(model_cfg) -> bool:
    """True when both grids of the model are dense (the kernels read dense
    grids only)."""
    return (getattr(model_cfg, "density_type", "") == "DenseGrid"
            and getattr(model_cfg, "k0_type", "") == "DenseGrid")


def frame_path(model_mod, model_cfg, params, buffers, data: DataFlags,
               stepsize: float) -> str:
    """Which renderer serves this model: ``"sweep"`` (the NDC plane-sweep
    kernel), ``"box"`` (the bounded-scene kernel) or ``"chunked"`` (the
    module's ``forward`` in ray chunks). The sweep kernel composites 3
    channels, so a DirectMPIGO with ``dim_rend > 3`` (its rend layer) is
    chunked."""
    if (model_mod is dmpigo and "rgbnet" in params
            and model_cfg.dim_rend <= 3 and dense_grids(model_cfg)
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
                      eval_lpips_vgg: bool = False,
                      eval_lpips_alex: bool = False, render_factor: int = 0,
                      render_video_flipy: bool = False,
                      render_video_rot90: int = 0, verbose: bool = True,
                      device=None) -> dict:
    """Render every pose and, with ``gt_imgs``, score the frames.

    ``model_mod`` is the model's module (``models.dmpigo``,
    ``models.dvqgo``, ``models.dvgo`` or ``models.dcvgo``);
    ``render_kwargs`` holds
    ``stepsize``, ``bg`` and, for bounded scenes, ``near`` and ``far``.
    ``render_factor`` divides the
    resolution and the intrinsics for previews and skips the metrics;
    ``render_video_flipy`` / ``render_video_rot90`` flip or rotate the
    finished frames. ``eval_lpips_vgg`` / ``eval_lpips_alex`` score LPIPS
    with the ``lpips`` package's network of that name, where the package
    is installed (else no value). Returns ``rgbs [N,H,W,3]``,
    ``rgb_features``, ``depths [N,H,W]``, ``bgmaps`` as tensors on the
    device, the per-frame ``psnrs`` / ``ssims`` / ``lpips_vgg`` /
    ``lpips_alex`` and ``frame_times`` (seconds, host clock), and the
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
        elif model_mod is not dvqgo:
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
    lpips = {"vgg": [], "alex": []}
    lpips_on = {"vgg": eval_lpips_vgg, "alex": eval_lpips_alex}
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
            for net, on in lpips_on.items():
                lp = metrics.rgb_lpips(gt, rgb, net) if on else None
                if lp is not None:
                    lpips[net].append(lp)
    if verbose and psnrs:
        print(f"render_viewpoints: psnr {np.mean(psnrs):.2f}"
              + (f" ssim {np.mean(ssims):.4f}" if ssims else "")
              + "".join(f" lpips({net}) {np.mean(v):.4f}"
                        for net, v in lpips.items() if v))
    maps = [rgbs, feats, depths, bgmaps]
    if render_video_flipy:
        maps = [[x.flip(0) for x in m] for m in maps]
    if render_video_rot90 != 0:
        k = int(render_video_rot90)
        maps = [[torch.rot90(x, k, (0, 1)) for x in m] for m in maps]
    rgbs, feats, depths, bgmaps = (torch.stack(m) for m in maps)
    return {"rgbs": rgbs, "rgb_features": feats, "depths": depths,
            "bgmaps": bgmaps, "psnrs": psnrs, "ssims": ssims,
            "lpips_vgg": lpips["vgg"], "lpips_alex": lpips["alex"],
            "frame_times": frame_times, "path": path}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "rgb")


def compute_bbox_by_cam_frustrm(cfg, HW, Ks, poses, i_train, near, far,
                                near_clip=None, device=None):
    """The scene box that holds every training camera's frustum between
    ``near`` and ``far`` (frozoul/4K-NeRF run.py:207-254), float64 on the
    host. An unbounded inward-facing scene gets its own rule
    (:func:`compute_bbox_unbounded`) at ``near_clip`` (``near`` when
    None)."""
    dev = resolve_device(device)
    if cfg.data.get("unbounded_inward", False):
        return compute_bbox_unbounded(
            cfg, HW, Ks, poses, i_train,
            near if near_clip is None else near_clip, dev)
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


def compute_bbox_unbounded(cfg, HW, Ks, poses, i_train, near_clip: float,
                           device=None):
    """The foreground cube of an unbounded inward-facing scene
    (frozoul/4K-NeRF run.py:223-239): the box of every training ray's
    point at ``near_clip`` (along the unnormalised direction), made a cube
    about its centre with the half-side of its longest axis, times
    ``data.unbounded_inner_r``; the contraction takes what lies outside.
    Float64 on the host."""
    dev = resolve_device(device)
    xyz_min = np.full(3, np.inf)
    xyz_max = -xyz_min
    for i in i_train:
        H, W = (int(v) for v in HW[i])
        ro, rd, _ = ray_ops.get_rays_of_a_view(
            H, W, Ks[i], poses[i], ndc=cfg.data.ndc,
            inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y, device=dev)
        pts = (ro + rd * float(near_clip)).reshape(-1, 3)
        xyz_min = np.minimum(xyz_min, pts.amin(0).cpu().numpy())
        xyz_max = np.maximum(xyz_max, pts.amax(0).cpu().numpy())
    center = (xyz_min + xyz_max) * 0.5
    radius = float((center - xyz_min).max()) * float(
        cfg.data.get("unbounded_inner_r", 1.0))
    return center - radius, center + radius


@torch.no_grad()
def compute_bbox_by_coarse_geo(model_mod, ckpt_path: str, thres: float,
                               device=None):
    """The box of the voxels of a coarse checkpoint whose alpha exceeds
    ``thres`` (frozoul/4K-NeRF run.py:257-278), the alphas computed on
    ``device`` (default ``cuda``) at the grid's voxel centres in x-slabs.
    Returns (xyz_min, xyz_max) as float64 numpy: the linspace coordinates
    of the first and last such voxel on each axis; the checkpoint's own box
    when no voxel qualifies."""
    dev = resolve_device(device)
    kwargs, params, _, _, _, _ = checkpoints.load_checkpoint(ckpt_path,
                                                             device=dev)
    cfg = model_mod.make_config(**kwargs)
    axes = [np.linspace(cfg.xyz_min[d], cfg.xyz_max[d], cfg.world_size[d])
            for d in range(3)]
    ax32 = [torch.as_tensor(a.astype(np.float32), device=dev) for a in axes]
    xyz_min = torch.tensor(cfg.xyz_min, dtype=torch.float32, device=dev)
    xyz_max = torch.tensor(cfg.xyz_max, dtype=torch.float32, device=dev)
    shift = getattr(cfg, "act_shift", 0.0)
    any_x = torch.zeros(cfg.world_size[0], dtype=torch.bool, device=dev)
    any_yz = torch.zeros(cfg.world_size[1:], dtype=torch.bool, device=dev)
    for x0 in range(0, cfg.world_size[0], _SLAB):
        xyz = torch.stack(torch.meshgrid(ax32[0][x0:x0 + _SLAB], ax32[1],
                                         ax32[2], indexing="ij"), -1)
        dens = grid_sample.grid_query(params["density"], xyz, xyz_min,
                                      xyz_max)[..., 0]
        hit = render.raw2alpha(dens, shift, cfg.voxel_size_ratio) > thres
        any_x[x0:x0 + _SLAB] = hit.flatten(1).any(1)
        any_yz |= hit.any(0)
    if not bool(any_x.any()):
        # degenerate coarse geometry (a very short run): the full box
        print("compute_bbox_by_coarse_geo: no voxel above threshold; keeping "
              "full bbox")
        return np.asarray(cfg.xyz_min), np.asarray(cfg.xyz_max)
    idx = [torch.nonzero(a)[:, 0].cpu().numpy()
           for a in (any_x, any_yz.any(1), any_yz.any(0))]
    return (np.array([axes[d][idx[d][0]] for d in range(3)]),
            np.array([axes[d][idx[d][-1]] for d in range(3)]))


_SLAB = 16          # x-slab of a full-grid query
_HIT_CHUNK = 65536  # rays a coarse-geometry hit test takes at once
_PATCH_SAMPLERS = ("patch_simg", "patch_mimg", "patch_inmask")


def _hit_rays(model, ro, rd, render_kwargs):
    """``[n]`` bool: whether each ray ``ro, rd [n, 3]`` meets the
    occupancy mask of ``model = (model_mod, model_cfg, buffers)``
    (``hit_coarse_geo``), in chunks of ``_HIT_CHUNK`` rays."""
    model_mod, model_cfg, buffers = model
    kw = {k: render_kwargs[k] for k in ("near", "far", "stepsize")}
    return torch.cat([model_mod.hit_coarse_geo(
        model_cfg, buffers, ro[s:s + _HIT_CHUNK], rd[s:s + _HIT_CHUNK], **kw)
        for s in range(0, ro.shape[0], _HIT_CHUNK)])


def gather_training_rays(cfg, cfg_train, data_dict, device=None, *,
                         model=None, render_kwargs=None):
    """The rays and colours of every training view on the device:
    ``flat`` and the per-view ``[H, W, 3]`` lists. ``flat`` holds ``[n, 3]``
    each for the ``flatten`` sampler, the rays that meet the occupancy mask
    of ``model`` (``(model_mod, model_cfg, buffers)``) for
    ``in_maskcache``, and ``[V, H, W, 3]`` for ``random`` and the patch
    samplers; for ``patch_inmask`` with a model that has
    ``hit_coarse_geo`` also ``hit``, the per-view hit maps ``[V, H, W]``
    (numpy bool). ``render_kwargs`` (``near``, ``far``, ``stepsize``) goes
    to the hit test."""
    sampler = cfg_train.ray_sampler
    if sampler not in ("flatten", "random", "in_maskcache", "patch_box") \
            + _PATCH_SAMPLERS:
        raise NotImplementedError(sampler)
    hit_test = model is not None and hasattr(model[0], "hit_coarse_geo")
    if sampler == "in_maskcache" and not hit_test:
        raise ValueError("the in_maskcache sampler needs a model with an "
                         "occupancy hit test (DirectVoxGO)")
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
    elif sampler == "in_maskcache":
        # the rays that meet the coarse geometry (lib/dvgo.py:643-680)
        kept = {k: [] for k in _RAY_KEYS}
        for v in range(len(lists["rgb"])):
            hit = _hit_rays(model, lists["rays_o"][v].reshape(-1, 3),
                            lists["rays_d"][v].reshape(-1, 3), render_kwargs)
            for k in _RAY_KEYS:
                kept[k].append(lists[k][v].reshape(-1, 3)[hit])
        flat = {k: torch.cat(v) for k, v in kept.items()}
        if flat["rgb"].shape[0] == 0:
            raise ValueError("in_maskcache: no training ray meets the "
                             "occupancy mask (an untrained coarse stage?)")
    else:
        flat = {k: torch.stack(v) for k, v in lists.items()}
        if sampler == "patch_inmask" and hit_test:
            # the patches whose rays all miss the occupancy mask leave the
            # rotation (lib/dvgo.py:786-820)
            flat["hit"] = np.stack([
                _hit_rays(model, ro.reshape(-1, 3), rd.reshape(-1, 3),
                          render_kwargs).reshape(ro.shape[:2]).cpu().numpy()
                for ro, rd in zip(lists["rays_o"], lists["rays_d"])])
    return flat, lists


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device: a pinned
    copy sent with ``non_blocking`` (a pageable one would synchronise)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def patch_origins(H: int, W: int, patch: int):
    """Grid-aligned patch rows and columns, clamped to the border."""
    rows = sorted({min(r, H - patch) for r in range(0, H, patch)})
    cols = sorted({min(c, W - patch) for c in range(0, W, patch)})
    return rows, cols


def epoch_sampler(items: list, seed: int):
    """``sample(step) -> item`` for the 0-based draw ``step``: every item
    once an epoch, in the order of numpy
    ``default_rng((seed, epoch)).permutation``."""
    cache = {"epoch": -1, "order": None}

    def sample(step: int):
        epoch, i = divmod(step, len(items))
        if cache["epoch"] != epoch:
            cache["epoch"] = epoch
            cache["order"] = np.random.default_rng((seed, epoch)).permutation(
                len(items))
        return items[cache["order"][i]]

    return sample


def make_batch_sampler(sampler: str, flat: dict, n_rand: int, seed: int,
                       hit: np.ndarray | None = None):
    """``sample(step) -> (kind, indices)`` for the 0-based draw ``step``
    (frozoul/4K-NeRF lib/dvgo.py:761-878). Each epoch's permutation is a
    pure function of ``(seed, epoch)`` and each ``random`` draw of
    ``(seed, step)``, so a resumed run replays the stream.

    The patch samplers draw square patches of side ``sample.patch``
    (``N_rand // 64``, at most the frame, down to a multiple of 8, at least
    8) at grid-aligned origins clamped to the border, as ``("patch",
    (view, row, col))`` in host ints: ``patch_simg`` every origin of one
    view, shuffled, before the next view; ``patch_mimg`` every (view,
    origin), shuffled per epoch; ``patch_inmask`` the same without the
    patches whose rays all miss the occupancy mask (``hit [V, H, W]``;
    never all of them); ``patch_box`` as ``patch_mimg`` with the side the
    largest multiple of 8 whose square is at most ``N_rand`` (at least
    8)."""
    dev = flat["rgb"].device
    if sampler in ("flatten", "in_maskcache"):
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
    if sampler not in _PATCH_SAMPLERS + ("patch_box",):
        raise NotImplementedError(sampler)
    V, H, W = flat["rgb"].shape[:3]
    if sampler == "patch_box":  # the slab sweep's patches: P^2 <= N_rand
        P = max((int(np.sqrt(n_rand)) // 8) * 8, 8)
    else:
        P = max((min(n_rand // 64, H, W) // 8) * 8, 8)
    rows, cols = patch_origins(H, W, P)
    pos = [(r, c) for r in rows for c in cols]
    if sampler == "patch_simg":
        def sample(step: int):
            block, i = divmod(step, len(pos))
            r, c = pos[np.random.default_rng((seed, block)).permutation(
                len(pos))[i]]
            return "patch", (block % V, r, c)
    else:
        combos = [(v, r, c) for v in range(V) for (r, c) in pos]
        if sampler == "patch_inmask" and hit is not None:
            kept = [(v, r, c) for (v, r, c) in combos
                    if hit[v][r:r + P, c:c + P].any()]
            if kept:  # never filter down to nothing
                combos = kept
        sample = epoch_sampler([("patch", cb) for cb in combos], seed)

    sample.patch = P
    return sample


def gather_batch(flat: dict, kind: str, sel, patch: int = 0):
    """(rays_o, rays_d, viewdirs, rgb) of one draw of the sampler;
    ``patch``: the side of a ``"patch"`` draw."""
    if kind == "flat":
        return tuple(flat[k][sel] for k in _RAY_KEYS)
    if kind == "patch":
        v, r, c = sel
        return tuple(flat[k][v, r:r + patch, c:c + patch].reshape(-1, 3)
                     for k in _RAY_KEYS)
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


def live_groups(tree: dict, groups) -> dict:
    """The groups of ``tree`` named in ``groups``, every leaf a detached
    copy that requires grad: the leaves a step differentiates."""
    return {k: _detached_leaves(tree[k]) for k in groups}


def tree_grads(loss, *trees) -> tuple:
    """The gradients of ``loss`` with respect to the leaves of each tree of
    ``trees``, one tree of gradients for each in its layout, by one
    ``autograd.grad``; a leaf that the loss does not reach gets zeros."""
    leaves = []
    for tree in trees:
        _flatten(tree, leaves)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    filled = (torch.zeros_like(x) if g is None else g
              for x, g in zip(leaves, grads))
    return tuple(_unflatten(tree, filled) for tree in trees)


def forward_kwargs(model_mod, render_kwargs: dict) -> dict:
    """The keyword arguments of a family's training forward from a stage's
    ``render_kwargs``; a DirectVoxGO (a bounded scene) also samples between
    ``near`` and ``far``."""
    kw = dict(stepsize=render_kwargs["stepsize"], bg=render_kwargs["bg"],
              rand_bkgd=bool(render_kwargs.get("rand_bkgd", False)),
              is_train=True,
              ndc_planes=bool(render_kwargs.get("ndc_planes", False)))
    if model_mod is dvgo:
        kw.update(near=render_kwargs["near"], far=render_kwargs["far"])
    return kw


def add_tv_(model_mod, model_cfg, params, grads, weights: dict, n_rays: int,
            dense: bool) -> None:
    """Add to ``grads`` in place the TV gradient of each grid that
    ``weights`` gives a positive loss weight and that has a gradient, by the
    model's ``tv_weights`` (sparse mode, without ``dense``: only where the
    gradient is non-zero; ``common.grid_tv_add_``)."""
    for name, weight in weights.items():
        if weight > 0 and name in grads:
            common.grid_tv_add_(getattr(model_cfg, f"{name}_type"),
                                params[name], grads[name],
                                *model_mod.tv_weights(model_cfg, weight,
                                                      n_rays), dense)


_STEP = trace.span("train_step", root=True)
_FORWARD = trace.span("train.forward")
_BACKWARD = trace.span("train.backward")
_ADAM = trace.span("train.adam")


class TrainStep:
    """One encoder training step for a fixed model configuration (one
    progressive-scaling phase): the loss and its gradients by autograd,
    the TV gradients added, MaskedAdam applied to the params in place, and
    a DirectQVGO's EMA codebook after this batch (its training forward's
    ``vq_state``) put in the buffers in place, as the JAX loop threads it
    into its buffers after each step. ``near_thres``: the near-clip loss's
    distance on the normalised lattice (a DirectContractedVoxGO with a
    ``near_clip``), else None. ``forward_fn`` replaces the module's
    ``forward`` (same arguments; the slab sweep of a ``patch_box`` plan,
    :func:`make_box_train_steps`)."""

    def __init__(self, model_mod, model_cfg, cfg_train, *,
                 render_kwargs: dict, skip_zero_grad=frozenset(),
                 near_thres: float | None = None, forward_fn=None):
        self.model_mod, self.model_cfg = model_mod, model_cfg
        self.forward_fn = forward_fn or model_mod.forward
        self.cfg_train = cfg_train
        self.skip_zero_grad = frozenset(skip_zero_grad)
        self.near_thres = near_thres
        self.fwd_kw = forward_kwargs(model_mod, render_kwargs)
        self.weight_tv_density = float(cfg_train.weight_tv_density)
        self.weight_tv_k0 = float(cfg_train.weight_tv_k0)

    def loss_and_grads(self, params, buffers, batch, groups, bg_noise=None):
        """(loss, terms, grads) of one batch; ``grads`` holds the param
        groups named in ``groups``, in the layout of ``params``."""
        return self._loss_grads_state(params, buffers, batch, groups,
                                      bg_noise)[:3]

    def _loss_grads_state(self, params, buffers, batch, groups, bg_noise):
        """:meth:`loss_and_grads` and the forward's ``vq_state`` (None for
        a model without a codebook)."""
        rays_o, rays_d, viewdirs, target = batch
        live = live_groups(params, groups)
        with _FORWARD:
            out = self.forward_fn(
                self.model_cfg, {**params, **live}, buffers, rays_o, rays_d,
                viewdirs, bg_noise=bg_noise, **self.fwd_kw)
            loss, terms = losses.encoder_losses(out, target, self.cfg_train,
                                                rays_o.shape[0],
                                                near_thres=self.near_thres)
        with _BACKWARD:
            grads, = tree_grads(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in terms.items()},
                grads, out.get("vq_state"))

    @trace.span("train.tv")
    @torch.no_grad()
    def add_tv(self, params, grads, n_rays: int, tv_dense: bool) -> None:
        """Add the TV gradients of the density and k0 grids to ``grads``
        in place (sparse mode: only where the gradient is non-zero). A
        model without a k0 grid (DirectQVGO) has no k0 TV."""
        add_tv_(self.model_mod, self.model_cfg, params, grads,
                {"density": self.weight_tv_density, "k0": self.weight_tv_k0},
                n_rays, tv_dense)

    def __call__(self, params, buffers, opt_state, batch, lrs, per_lr,
                 bg_noise, *, apply_tv: bool, tv_dense: bool):
        """One step; updates ``params``, ``opt_state`` and a codebook's
        ``buffers["vq_state"]`` in place and returns (loss, psnr) as device
        scalars."""
        with _STEP:
            loss, terms, grads, vq_state = self._loss_grads_state(
                params, buffers, batch, lrs.keys(), bg_noise)
            if apply_tv:
                self.add_tv(params, grads, batch[0].shape[0], tv_dense)
            with _ADAM:
                optim.apply_updates(params, grads, opt_state, lrs,
                                    skip_zero_grad=self.skip_zero_grad,
                                    per_lr=per_lr)
            if vq_state is not None:
                buffers["vq_state"] = vq_state
            psnr = -10.0 * torch.log10(
                terms["mse"] / max(self.cfg_train.weight_main, 1e-12))
        return loss, psnr



def compute_box_plans(model_cfg, rays: dict, render_kwargs: dict,
                      patch: int):
    """The ``patch_box`` plans of a stage: per training view its
    ``(axis, flip, S)`` (``box_sweep.box_train_plan`` of all its rays) and
    one slab window ``(Pu, Pv)`` that holds every sampler patch of every
    view (``box_sweep.box_window_size_for``). ``rays`` holds ``rays_o``,
    ``rays_d`` and ``viewdirs`` by view (``[H, W, 3]`` each). Returns
    (plans, (Pu, Pv)), or (None, None) when a view has no dominant axis or
    its window would be too wide: the stage then trains through the gather
    forward. The JAX package caps the window at the minor extents of every
    view's axis, so that one slice fits every view; where a grid's extents
    differ that cut a view's footprint, and its samples outside the window
    lost their corners. The port does not cap it: a view whose extents are
    narrower than the window reads its grid whole
    (``sweep_rays_train_box``)."""
    stepsize, near = render_kwargs["stepsize"], render_kwargs["near"]
    plans, Pu, Pv = [], 8, 8
    for v in range(len(rays["rays_o"])):
        ro, rd, vd = (rays[k][v] for k in ("rays_o", "rays_d", "viewdirs"))
        plan = box_sweep.box_train_plan(model_cfg, ro, rd, stepsize=stepsize,
                                        near=near)
        if plan is None:
            return None, None
        rows, cols = patch_origins(*ro.shape[:2], patch)

        def tiles(x):
            return torch.stack([x[r:r + patch, c:c + patch].reshape(-1, 3)
                                for r in rows for c in cols])

        pupv = box_sweep.box_window_size_for(
            model_cfg, tiles(ro), tiles(rd), tiles(vd), stepsize=stepsize,
            near=near, axis=plan[0], flip=plan[1])
        if pupv is None:
            return None, None
        plans.append(plan)
        Pu, Pv = max(Pu, pupv[0]), max(Pv, pupv[1])
    return plans, (Pu, Pv)


def make_box_train_steps(model_mod, model_cfg, cfg_train, *, render_kwargs,
                         skip_zero_grad, Pu: int, Pv: int, near_thres=None):
    """``step_for(axis, flip, S)``: the :class:`TrainStep` of a
    ``patch_box`` plan, whose forward is the slab sweep of that plan over
    the ``(Pu, Pv)`` window (at the JAX trainer's bf16 rounding), one a
    plan."""
    steps: dict = {}

    def step_for(axis: int, flip: bool, S: int) -> TrainStep:
        key = (axis, flip, S)
        if key not in steps:
            def forward(cfg, params, buffers, ro, rd, vd, **kw):
                return box_sweep.sweep_rays_train_box(
                    cfg, params, buffers, ro, rd, vd, axis=axis, flip=flip,
                    S=S, Pu=Pu, Pv=Pv, **kw)
            steps[key] = TrainStep(
                model_mod, model_cfg, cfg_train, render_kwargs=render_kwargs,
                skip_zero_grad=skip_zero_grad, near_thres=near_thres,
                forward_fn=forward)
        return steps[key]

    return step_for


def find_reload_path(args, rundir: str, stage: str, flag: str = "ft_path",
                     periodic_dir: str = ""):
    """The checkpoint a run resumes from: the path of its flag ``flag``
    (run.py's ``--ft_path``, run_sr.py's ``--ftdv_path``), else the stage's
    last checkpoint, else the periodic one under ``rundir/periodic_dir``
    (run_sr.py's ``ckpt_saved``) with the largest step (by the parsed
    integer: ``fine_1000000`` comes after ``fine_999999``; temporary files
    do not parse), else None. ``--no_reload`` gives None."""
    if getattr(args, "no_reload", False):
        return None
    if getattr(args, flag, ""):
        return getattr(args, flag)
    last = os.path.join(rundir, f"{stage}_last.npz")
    if os.path.isfile(last):
        return last
    steps = {}
    for p in glob.glob(os.path.join(rundir, periodic_dir, f"{stage}_*.npz")):
        tail = os.path.basename(p)[len(stage) + 1:-len(".npz")]
        if tail.isdigit():  # not the last or a temporary file
            steps[p] = int(tail)
    return max(steps, key=steps.get) if steps else None


def steps_since_reset_at(pg_scale, start: int) -> int:
    """Optimizer steps since the last progressive-scaling boundary at or
    before ``start`` (the global step a run starts after)."""
    prior = [b for b in pg_scale if b <= start]
    return start - (max(prior) if prior else 0)


def tv_schedule(cfg_train, global_step: int) -> tuple:
    """``(apply_tv, tv_dense)`` of ``global_step``: TV on every
    ``tv_every``-th step strictly between ``tv_after`` and ``tv_before``,
    dense before ``tv_dense_before``."""
    return (bool(cfg_train.tv_after < global_step < cfg_train.tv_before
                 and global_step % cfg_train.tv_every == 0),
            bool(global_step < cfg_train.tv_dense_before))


def stage_render_kwargs(model_mod, model_cfg, cfg, cfg_model,
                        data_dict) -> dict:
    """A stage's render settings: ``near``, ``far``, ``bg``, ``rand_bkgd``,
    ``stepsize`` and, for a DirectMPIGO, ``ndc_planes``."""
    rk = {"near": float(data_dict["near"]), "far": float(data_dict["far"]),
          "bg": 1.0 if cfg.data.white_bkgd else 0.0,
          "rand_bkgd": bool(cfg.data.rand_bkgd),
          "stepsize": float(cfg_model.stepsize)}
    if model_mod is dmpigo:
        rk["ndc_planes"] = dmpigo.plane_aligned_ok(model_cfg, rk["stepsize"],
                                                   cfg.data.ndc)
    return rk


class EncoderStage:
    """One stage's encoder as both loops (:func:`scene_rep_reconstruction`,
    ``sr_trainer.scene_rep_reconstruction_sr_patch``) run it
    (run.py:280-332, :455-476): new, or reloaded from ``reload_path``;
    its ``render_kwargs``; its lr clock ``since_reset``, which the loop
    counts up after each step; :meth:`advance` before each step. The loop
    owns its step, its optimizer state ``opt`` and its saves."""

    def __init__(self, model_mod, cfg, cfg_model, cfg_train, xyz_min,
                 xyz_max, data_dict, *, reload_path, coarse_ckpt_path, seed,
                 device):
        """New: in the box grown by ``world_bound_scale``, at the first
        ``pg_scale`` size, on the free-space mask of ``coarse_ckpt_path``
        unless NDC. Reloaded: a reference ``.tar``, or an ``.npz`` whose
        optimizer state, global step and metadata are ``opt_loaded``,
        ``start`` and ``meta``."""
        dev = resolve_device(device)
        self.model_mod, self.cfg_model = model_mod, cfg_model
        self.cfg_train = cfg_train
        self.start, self.opt_loaded, self.meta, self.opt = 0, None, {}, None
        if reload_path is None:
            if abs(cfg_model.world_bound_scale - 1) > 1e-9:
                shift = ((xyz_max - xyz_min)
                         * (cfg_model.world_bound_scale - 1) / 2)
                xyz_min, xyz_max = xyz_min - shift, xyz_max + shift
            kw = dict(cfg_model)
            if len(cfg_train.pg_scale):
                kw["num_voxels"] = int(kw["num_voxels"]
                                       / (2 ** len(cfg_train.pg_scale)))
            if model_mod not in (dmpigo, dvqgo):  # only the MPI family's
                kw.pop("mpi_depth", None)
            self.model_cfg = model_mod.make_config(xyz_min=xyz_min,
                                                   xyz_max=xyz_max, **kw)
            mask_kw = {}
            if not cfg.data.ndc and coarse_ckpt_path:
                mask_kw["init_mask"] = coarse_mask_on_grid(
                    self.model_cfg, coarse_ckpt_path,
                    cfg_model.mask_cache_thres, dev)
            self.params, self.buffers = model_mod.init(
                self.model_cfg, generator=torch.Generator().manual_seed(seed),
                device=dev, **mask_kw)
        else:
            if reload_path.endswith(".tar"):  # a reference torch checkpoint
                kwargs, p_np, b_np, self.start = \
                    checkpoints.import_torch_encoder_checkpoint(reload_path)
                self.params, self.buffers = (weights.to_torch(t, dev)
                                             for t in (p_np, b_np))
            else:
                (kwargs, self.params, self.buffers, self.opt_loaded,
                 self.start, self.meta) = checkpoints.load_checkpoint(
                    reload_path, device=dev)
            self.model_cfg = model_mod.make_config(**kwargs)
        self.render_kwargs = stage_render_kwargs(
            model_mod, self.model_cfg, cfg, cfg_model, data_dict)
        self.since_reset = int(self.meta["steps_since_reset"]) \
            if "steps_since_reset" in self.meta \
            else steps_since_reset_at(cfg_train.pg_scale, self.start)

    def advance(self, global_step: int) -> bool:
        """Before step ``global_step``: the occupancy refresh
        (run.py:461-462); at a ``pg_scale`` boundary (run.py:465-476) the
        grids resampled (DirectMPIGO keeps its depth and lowers its
        act_shift by ``decay_after_scale``), fresh moments and the clock
        reset, and True (the loop rebuilds its step for the new
        ``model_cfg``)."""
        if (global_step + 500) % 1000 == 0:
            self.buffers = self.model_mod.update_occupancy_cache(
                self.model_cfg, self.params, self.buffers)
        pg_scale = self.cfg_train.pg_scale
        if global_step not in pg_scale:
            return False
        n_rest = len(pg_scale) - pg_scale.index(global_step) - 1
        num_voxels = int(self.cfg_model.num_voxels / (2 ** n_rest))
        self.opt = None  # the old moments go before the grids grow
        if self.model_mod is dmpigo:
            self.model_cfg, self.params, buffers = dmpigo.scale_volume_grid(
                self.model_cfg, self.params, self.buffers, num_voxels,
                self.model_cfg.mpi_depth)
            self.buffers = dmpigo.decay_act_shift(
                buffers, self.cfg_train.decay_after_scale)
        else:
            self.model_cfg, self.params, self.buffers = \
                self.model_mod.scale_volume_grid(
                    self.model_cfg, self.params, self.buffers, num_voxels)
        self.opt = optim.init_state(self.params)
        self.since_reset = 0
        return True


def coarse_mask_on_grid(model_cfg, coarse_ckpt_path: str, thres: float,
                       device=None) -> torch.Tensor:
    """The free-space mask of a coarse checkpoint (``.npz``, or a reference
    ``.tar``) resampled by nearest lookup onto the voxels of
    ``model_cfg.mask_cache_world_size`` over this model's box
    (run.py:351-362): ``[X, Y, Z]`` bool on ``device``."""
    dev = resolve_device(device)
    load = (checkpoints.mask_from_coarse_torch_checkpoint
            if coarse_ckpt_path.endswith(".tar")
            else checkpoints.mask_from_coarse_checkpoint)
    mask, m_min, m_max = load(coarse_ckpt_path, thres, device=dev)
    axes = [torch.as_tensor(np.linspace(
        model_cfg.xyz_min[d], model_cfg.xyz_max[d],
        model_cfg.mask_cache_world_size[d]).astype(np.float32), device=dev)
        for d in range(3)]
    xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    return grid_sample.nearest_mask_lookup(
        mask, xyz, torch.as_tensor(m_min, dtype=torch.float32, device=dev),
        torch.as_tensor(m_max, dtype=torch.float32, device=dev))


def scene_rep_reconstruction(args, cfg, cfg_model, cfg_train, xyz_min,
                             xyz_max, data_dict, stage: str,
                             coarse_ckpt_path: str | None = None,
                             writer=None, device=None):
    """Train one stage on ``device`` (default ``cuda``); a fine stage
    that is not NDC starts from the mask of ``coarse_ckpt_path``. Returns
    (model_mod, model_cfg, params, buffers)."""
    dev = resolve_device(device)
    model_mod = select_model_mod(cfg)
    _refuse_unscalable(model_mod, cfg_train)
    if cfg_train.pervoxel_lr and model_mod in (dmpigo, dvqgo):
        raise ValueError("the per-voxel lr counts the views of a box's "
                         "voxels (DirectVoxGO, DirectContractedVoxGO)")
    seed = int(getattr(args, "seed", 777))
    rundir = os.path.join(cfg.basedir, cfg.expname)
    last_ckpt_path = os.path.join(rundir, f"{stage}_last.npz")
    near = float(data_dict["near"])

    # --- model: new, or reloaded (run.py:280-332) ---------------------------
    reload_path = find_reload_path(args, rundir, stage)
    if reload_path is not None:
        print(f"scene_rep_reconstruction ({stage}): reload from {reload_path}")
    enc = EncoderStage(model_mod, cfg, cfg_model, cfg_train, xyz_min, xyz_max,
                       data_dict, reload_path=reload_path,
                       coarse_ckpt_path=coarse_ckpt_path, seed=seed,
                       device=dev)
    if (reload_path is None and cfg_model.maskout_near_cam_vox
            and model_mod is dvgo):
        enc.params = dvgo.maskout_near_cam_vox(
            enc.model_cfg, enc.params,
            np.asarray(data_dict["poses"])[data_dict["i_train"], :3, 3], near)
    render_kwargs = enc.render_kwargs
    data_flags = DataFlags.from_config(cfg.data)

    # --- rays and sampler ----------------------------------------------------
    flat, ray_lists = gather_training_rays(
        cfg, cfg_train, data_dict, dev,
        model=(model_mod, enc.model_cfg, enc.buffers),
        render_kwargs=render_kwargs)
    sample_batch = make_batch_sampler(cfg_train.ray_sampler, flat,
                                      cfg_train.N_rand, seed,
                                      hit=flat.pop("hit", None))
    patch = getattr(sample_batch, "patch", 0)

    # --- per-voxel lr (run.py:438-446) ---------------------------------------
    per_lr = None
    if cfg_train.pervoxel_lr:
        cnt = dvgo.voxel_count_views(
            enc.model_cfg, ray_lists["rays_o"], ray_lists["rays_d"], near,
            cfg_model.stepsize, downrate=cfg_train.pervoxel_lr_downrate)
        per_lr = {"density": cnt / cnt.max().clamp_min(1.0)}
        if tuple(cnt.shape[:3]) == tuple(enc.buffers["mask_cache"].shape):
            enc.buffers = {**enc.buffers, "mask_cache":
                           enc.buffers["mask_cache"] & (cnt[..., 0] > 2)}
        del cnt
    if cfg_train.get("maskout_lt_nviews", 0) > 0 and model_mod is dmpigo:
        enc.buffers = dmpigo.update_occupancy_cache_lt_nviews(
            enc.model_cfg, enc.buffers, ray_lists["rays_o"],
            ray_lists["rays_d"], cfg_model.stepsize,
            cfg_train.maskout_lt_nviews)
    del ray_lists

    # --- optimizer -------------------------------------------------------------
    base_lrs = optim.build_group_lrs(cfg_train, enc.params)
    skip_zero = frozenset(cfg_train.skip_zero_grad_fields)
    enc.opt = optim.init_state(enc.params)
    if not getattr(args, "no_reload_optimizer", False):
        enc.opt, restored = optim.restore_state(enc.opt_loaded, enc.opt)
        if restored:
            print(f"scene_rep_reconstruction ({stage}): restored optimizer "
                  "state")
    enc.opt_loaded = None
    # the near-clip loss's distance on the normalised lattice (run.py:528)
    near_thres = None
    if model_mod is dcvgo and data_dict.get("near_clip") is not None:
        near_thres = (float(data_dict["near_clip"])
                      / enc.model_cfg.scene_radius[0])

    def make_step(mcfg):
        return TrainStep(model_mod, mcfg, cfg_train,
                         render_kwargs=render_kwargs,
                         skip_zero_grad=skip_zero, near_thres=near_thres)

    # patch_box: the slab sweep with a static plan per view; the gather
    # forward takes a stage that cannot have one (trainer.py:824-843 of
    # the JAX package)
    def setup_box_steps(mcfg):
        plans, pupv = compute_box_plans(mcfg, flat, render_kwargs, patch)
        if plans is None:
            print(f"scene_rep_reconstruction ({stage}): patch_box -> gather "
                  "forward (a view has no dominant axis or too wide a "
                  "window)")
            return None, None
        print(f"scene_rep_reconstruction ({stage}): patch_box slab-sweep ON "
              f"(window {pupv}, plans {sorted(set(plans))})")
        return plans, make_box_train_steps(
            model_mod, mcfg, cfg_train, render_kwargs=render_kwargs,
            skip_zero_grad=skip_zero, Pu=pupv[0], Pv=pupv[1],
            near_thres=near_thres)

    train_step = make_step(enc.model_cfg)
    box_plans, box_step_for = None, None
    patch_box = cfg_train.ray_sampler == "patch_box"
    if patch_box:
        if model_mod is dvgo:
            box_plans, box_step_for = setup_box_steps(enc.model_cfg)
        else:
            print(f"scene_rep_reconstruction ({stage}): patch_box -> gather "
                  "forward (the slab sweep serves DirectVoxGO)")
    box_routes = {"slab": 0, "gather": 0}

    collector = stats_mod.Collector()
    best_val_psnr = -1.0
    time0 = time.time()
    saver = checkpoints.AsyncSaver()
    try:
        for global_step in range(1 + enc.start, 1 + cfg_train.N_iters):
            if enc.advance(global_step):
                train_step = make_step(enc.model_cfg)
                if box_step_for is not None:
                    # the voxel size halved: S and the window change
                    box_plans, box_step_for = setup_box_steps(enc.model_cfg)

            kind, sel = sample_batch(global_step - 1)
            batch = gather_batch(flat, kind, sel, patch)
            step_fn = train_step
            if patch_box:
                route = "slab" if box_step_for is not None else "gather"
                box_routes[route] += 1
                if box_step_for is not None:
                    step_fn = box_step_for(*box_plans[sel[0]])
            lrs = {k: optim.group_lr(v, enc.since_reset,
                                     cfg_train.lrate_decay)
                   for k, v in base_lrs.items()}
            noise = (bkgd_noise(seed, global_step, batch[0].shape[0], dev)
                     if render_kwargs["rand_bkgd"] else None)
            apply_tv, tv_dense = tv_schedule(cfg_train, global_step)
            loss, psnr = step_fn(enc.params, enc.buffers, enc.opt, batch, lrs,
                                 per_lr, noise, apply_tv=apply_tv,
                                 tv_dense=tv_dense)
            enc.since_reset += 1
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
                    model_mod, enc.model_cfg, enc.params, enc.buffers,
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
                        model_mod.get_kwargs(enc.model_cfg), enc.params,
                        enc.buffers, global_step=global_step, saver=saver)

            if args.i_weights and global_step % args.i_weights == 0:
                checkpoints.save_checkpoint(
                    os.path.join(rundir, f"{stage}_{global_step:06d}.npz"),
                    model_mod.get_kwargs(enc.model_cfg), enc.params,
                    enc.buffers, enc.opt, global_step,
                    extra_meta={"steps_since_reset": enc.since_reset},
                    saver=saver)

        saver.wait_for_pending_saves()
        if patch_box:
            print(f"scene_rep_reconstruction ({stage}): patch_box steps: "
                  f"{box_routes['slab']} slab sweep, {box_routes['gather']} "
                  "gather forward")
        if cfg_train.N_iters > 0:
            checkpoints.save_checkpoint(
                last_ckpt_path, model_mod.get_kwargs(enc.model_cfg),
                enc.params, enc.buffers, enc.opt, cfg_train.N_iters,
                extra_meta={"steps_since_reset": enc.since_reset})
            print(f"scene_rep_reconstruction ({stage}): saved checkpoint at "
                  f"{last_ckpt_path}")
    finally:
        saver.close()
    return model_mod, enc.model_cfg, enc.params, enc.buffers


def select_model_mod(cfg):
    """The model family of a config (run.py:286-313,
    ``models.model_module``): DirectMPIGO for NDC scenes (DirectQVGO with
    ``mode_type`` adain_vq), DirectContractedVoxGO for unbounded
    inward-facing ones (``data.unbounded_inward``), DirectVoxGO for bounded
    ones."""
    return model_module(
        bool(cfg.data.ndc), bool(cfg.data.get("unbounded_inward", False)),
        cfg.fine_model_and_render.get("mode_type", ""))


def _refuse_unscalable(model_mod, cfg_train):
    """Raise for a DirectQVGO stage with a ``pg_scale``: the JAX package's
    DirectQVGO (its ``models/dvqgo.py``) has no ``scale_volume_grid``, so
    its loop stops with an AttributeError at the first scaling step; the
    port refuses the run before it starts."""
    if model_mod is dvqgo and len(cfg_train.pg_scale):
        raise ValueError(
            "DirectQVGO (mode_type adain_vq) cannot take a pg_scale step: "
            "the JAX package's dvqgo has no scale_volume_grid, and its loop "
            "fails with an AttributeError at the first scaling step; set "
            "pg_scale=[]")


def train(args, cfg, data_dict, writer=None, device=None):
    """Fit a scene (run.py:636-685) on ``device`` (default ``cuda``): the
    box of the training cameras' frustums (an unbounded scene's cube of
    near-clip points); with ``coarse_train.N_iters`` the coarse stage, then
    the box tightened to the coarse geometry (read as a DirectVoxGO's, or
    a DirectMPIGO's for NDC, whatever the family, as the JAX package
    reads it); then the
    fine stage (on the coarse mask, unless NDC). Returns (model_mod,
    model_cfg, params, buffers) of the fine stage."""
    model_mod = select_model_mod(cfg)
    stages = [cfg.fine_train] + ([cfg.coarse_train]
                                 if cfg.coarse_train.N_iters > 0 else [])
    for c in stages:
        _refuse_unscalable(model_mod, c)
    if model_mod is dcvgo and any(c.ray_sampler == "in_maskcache"
                                  for c in stages):
        raise ValueError("the in_maskcache sampler keeps the rays that hit "
                         "the occupancy mask, and DirectContractedVoxGO has "
                         "no hit test (its rays all cross the contracted "
                         "cube): use flatten or random")
    rundir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(rundir, exist_ok=True)
    xyz_min, xyz_max = compute_bbox_by_cam_frustrm(
        cfg, data_dict["HW"], data_dict["Ks"], data_dict["poses"],
        data_dict["i_train"], data_dict["near"], data_dict["far"],
        near_clip=data_dict.get("near_clip"), device=device)
    coarse_ckpt_path = None
    if cfg.coarse_train.N_iters > 0:
        scene_rep_reconstruction(
            args, cfg, cfg.coarse_model_and_render, cfg.coarse_train,
            xyz_min, xyz_max, data_dict, stage="coarse", writer=writer,
            device=device)
        coarse_ckpt_path = os.path.join(rundir, "coarse_last.npz")
        xyz_min, xyz_max = compute_bbox_by_coarse_geo(
            dmpigo if cfg.data.ndc else dvgo, coarse_ckpt_path,
            cfg.fine_model_and_render.bbox_thres, device=device)
    return scene_rep_reconstruction(
        args, cfg, cfg.fine_model_and_render, cfg.fine_train, xyz_min,
        xyz_max, data_dict, stage="fine", coarse_ckpt_path=coarse_ckpt_path,
        writer=writer, device=device)
