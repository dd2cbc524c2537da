"""Joint VC-Encoder + VC-Decoder training (the JAX package's
``train/sr_trainer.py``, after frozoul/4K-NeRF run_sr.py:626-1179).

One step renders an aligned low-resolution pixel patch with the voxel
encoder, decodes it with the SFT-conditioned generator (``SFTNet``), and
backpropagates the joint loss (the patch's L1, the SR output's L1, the
VGG19 perceptual and style terms, the generator's GAN term, background
entropy, distortion, per-point rgb, and TV scaled by the view count)
through the generator into the voxel grids. The encoder's groups take a
MaskedAdam step (only the patch's grid window where the step takes the
window), then the generator's own MaskedAdam over ``{"srnet": ...}``.
With a GAN weight, the discriminator step follows on the same patch: the
truth, then the detached SR output, each updating the spectral-norm
vectors, and the discriminator's MaskedAdam over ``{"d": ...}``. The
generator's GAN term reads the discriminator before its step, without
updating its vectors, and no gradient of the generator's loss reaches it.

The patch render is the JAX step's choice (``make_sr_train_step``): the
footprint window of the plane sweep when the mask has the grid's
resolution and no TV is applied, the full-grid plane sweep (the mask read
at its own resolution where it differs, NATIVE mode) when a sweep slice
fits, else the gather forward of ``dmpigo``. All three are plain torch ops
under autograd, as they are XLA code in the JAX package; the sweep rounds
to bfloat16 where the JAX sweep does.

Patches are the JAX package's: grid-aligned origins clamped to the border,
shuffled over (view x origin) by numpy ``default_rng((seed, epoch))`` and
indexed by step, so both packages draw the same patches and a resumed run
replays the stream. Joint checkpoints are the JAX package's files: the
generator under ``params/__sr__`` in flax's names and HWIO layout, the
discriminator under ``params/__disc__`` and its vectors under
``params/__disc_state__``, the optimizers under ``opt/{enc,sr,d}`` with an
int32 ``step`` each.
"""

from __future__ import annotations

import copy
import glob
import os
import time

import numpy as np
import torch

from fourk_nerf_torch import pipeline, weights
from fourk_nerf_torch.device import fp32_precision, resolve_device
from fourk_nerf_torch.models import dmpigo, sr_esrnet, sr_unetdisc
from fourk_nerf_torch.ops import grid_sample, plane_sweep, rays as ray_ops, \
    render
from fourk_nerf_torch.train import checkpoints, losses, optim, sr_losses, \
    trainer
from fourk_nerf_torch.utils import metrics, stats as stats_mod


# ---------------------------------------------------------------------------
# aligned LR/HR patch sampling
# ---------------------------------------------------------------------------

def patch_origins(H: int, W: int, patch: int):
    """Grid-aligned patch rows and columns, clamped to the border."""
    rows = sorted({min(r, H - patch) for r in range(0, H, patch)})
    cols = sorted({min(c, W - patch) for c in range(0, W, patch)})
    return rows, cols


def make_patch_sampler(n_views: int, H: int, W: int, patch: int, seed: int,
                       inmask: np.ndarray | None = None):
    """``sample(step) -> (view, row0, col0)`` for the 0-based draw ``step``:
    every (view, origin) once per epoch in the order of numpy
    ``default_rng((seed, epoch)).permutation``. ``inmask [n_combos]`` drops
    the patches whose rays all miss the occupancy cache (never all of
    them). The JAX package's sampler, draw for draw."""
    rows, cols = patch_origins(H, W, patch)
    combos = [(v, r, c) for v in range(n_views) for r in rows for c in cols]
    if inmask is not None:
        kept = [cb for cb, m in zip(combos, inmask) if m]
        if kept:
            combos = kept
    cache = {"epoch": -1, "order": None}

    def sample(step: int):
        epoch, i = divmod(step, len(combos))
        if cache["epoch"] != epoch:
            cache["epoch"] = epoch
            cache["order"] = np.random.default_rng((seed, epoch)).permutation(
                len(combos))
        return combos[cache["order"][i]]

    sample.rows, sample.cols = rows, cols
    return sample


def sweep_patch_size_for(model_cfg, a_all, b_all, rows, cols, patch_px: int):
    """The plane sweep's slice size (a multiple of 8, at least 16) that
    holds the footprint of every sampler patch of every view on the first
    and the last plane, or None when it would not fit the grid.
    ``a_all``, ``b_all``: ``[V, H, W, 2]`` numpy."""
    Z = model_cfg.world_size[2]
    spread = 0.0
    for k in (0.0, float(Z - 1)):
        p = a_all + b_all * np.float32(k)
        for r in rows:
            for c in cols:
                blk = p[:, r:r + patch_px, c:c + patch_px].reshape(len(p), -1,
                                                                   2)
                spread = max(spread, float((blk.max(1) - blk.min(1)).max()))
    size = int(np.ceil((spread + 4) / 8.0) * 8)
    if size > min(model_cfg.world_size[0], model_cfg.world_size[1]):
        return None
    return max(size, 16)


def sweep_window_size_for(model_cfg, a_all, b_all, rows, cols, patch_px: int,
                          sweep_patch: int):
    """The grid window size that holds the union footprint of every
    sampler patch over all planes (the hull of the first and the last
    plane's, since positions are affine in the plane), at least
    ``sweep_patch``; None when it would not fit the grid."""
    Z = model_cfg.world_size[2]
    p1 = a_all + b_all * np.float32(Z - 1)
    spread = 0.0
    for r in rows:
        for c in cols:
            b0 = a_all[:, r:r + patch_px, c:c + patch_px].reshape(len(a_all),
                                                                  -1, 2)
            b1 = p1[:, r:r + patch_px, c:c + patch_px].reshape(len(p1), -1, 2)
            mn = np.minimum(b0.min(1), b1.min(1))
            mx = np.maximum(b0.max(1), b1.max(1))
            spread = max(spread, float((mx - mn).max()))
    size = int(np.ceil((spread + 4) / 8.0) * 8)
    size = max(size, int(sweep_patch), 16)
    if size > min(model_cfg.world_size[0], model_cfg.world_size[1]):
        return None
    return size


def _force_image_sampler(cfg_train):
    """A copy of ``cfg_train`` whose sampler keeps the rays in image layout
    (``[V, H, W, 3]``), whatever the config names."""
    ct = copy.deepcopy(cfg_train)
    ct["ray_sampler"] = "random"
    return ct


# ---------------------------------------------------------------------------
# the joint step
# ---------------------------------------------------------------------------

class SRTrainStep:
    """One joint step for a fixed model configuration (one progressive-
    scaling phase): the encoder's patch render (window, sweep or gather,
    chosen as the JAX step chooses), the generator, the loss and its
    gradients by autograd, the TV gradients, then the encoder's and the
    generator's MaskedAdam in place, then, with a GAN weight, the
    discriminator's step. Runs in full float32 (no TF32).

    ``perceptual``: a :class:`~fourk_nerf_torch.train.sr_losses.
    PerceptualLoss` (the perceptual and style terms) or None;
    ``d_model``: the discriminator (``models.sr_unetdisc``), required when
    ``cfg_train.weight_gan > 0``."""

    def __init__(self, model_mod, model_cfg, cfg_train, cfg_model, *,
                 render_kwargs: dict, skip_zero_grad, sr_model, n_views: int,
                 patch: int, sr_ratio: int, sweep_patch: int | None = None,
                 grid_window: int | None = None, perceptual=None,
                 d_model=None):
        self.model_mod, self.model_cfg = model_mod, model_cfg
        self.cfg_train = cfg_train
        self.skip_zero_grad = frozenset(skip_zero_grad)
        self.sr_model = sr_model
        self.sr_params = weights.sftnet_params(sr_model)
        self.perceptual = perceptual
        self.use_gan = cfg_train.get("weight_gan", 0) > 0
        if self.use_gan and d_model is None:
            raise ValueError("weight_gan > 0 needs a discriminator")
        self.d_model = d_model if self.use_gan else None
        self.d_params = (sr_unetdisc.disc_params(d_model) if self.use_gan
                         else None)
        self.n_views, self.patch, self.sr_ratio = n_views, patch, sr_ratio
        self.sweep_patch, self.grid_window = sweep_patch, grid_window
        self.num_cond = int(cfg_model.get("num_cond", 1))
        self.rk = dict(render_kwargs)
        self.rand_bkgd = bool(render_kwargs.get("rand_bkgd", False))
        self.weight_tv_density = float(cfg_train.weight_tv_density)
        self.weight_tv_k0 = float(cfg_train.weight_tv_k0)

    def path(self, params, buffers, apply_tv: bool) -> str:
        """``"window"``, ``"sweep"`` or ``"gather"``: the JAX step's rule
        (sr_trainer.py:188-194, :230-245)."""
        if self.sweep_patch is None:
            return "gather"
        if (self.grid_window is not None and not apply_tv
                and {"density", "k0"} <= self.skip_zero_grad
                and tuple(buffers["mask_cache"].shape)
                == tuple(params["density"].shape[:3])):
            return "window"
        return "sweep"

    def window_origin(self, rays_o, rays_d):
        """The grid window's origin for a patch's rays (host ints; reads
        the rays back, so the trainer passes it in from host copies)."""
        X, Y, Z = self.model_cfg.world_size
        a, b = self._affine(rays_o, rays_d)
        return plane_sweep.sweep_window_origin(a, b, Z, X, Y,
                                               self.grid_window)

    def _affine(self, rays_o, rays_d):
        X, Y, Z = self.model_cfg.world_size
        dev = rays_o.device
        return plane_sweep.affine_coeffs(
            rays_o, rays_d,
            torch.tensor(self.model_cfg.xyz_min, dtype=torch.float32,
                         device=dev),
            torch.tensor(self.model_cfg.xyz_max, dtype=torch.float32,
                         device=dev),
            torch.tensor([X, Y], dtype=torch.float32, device=dev), Z)

    def _condition(self, depth, viewdirs):
        """The generator's condition ``[1, p, p, num_cond]``
        (run_sr.py:895-912)."""
        p = self.patch
        conds = []
        if self.num_cond in (1, 64):
            conds.append(depth.reshape(1, p, p, 1))
        if self.num_cond in (63, 64):
            vd = ray_ops.positional_encoding(viewdirs, 10)
            conds.append(vd.reshape(1, p, p, -1).detach())
        return torch.cat(conds, dim=-1)

    def render(self, params, buffers, rays_o, rays_d, viewdirs, *, path: str,
               bg_noise=None, origin=None) -> dict:
        """The encoder's patch render (the dense dict of
        ``dmpigo.forward``); ``params`` may hold grid windows (path
        ``"window"``, at ``origin``)."""
        stepsize, bg = self.rk["stepsize"], self.rk["bg"]
        noise = bg_noise if self.rand_bkgd else None
        if path == "window":
            a, b = self._affine(rays_o, rays_d)
            gw = self.grid_window
            win_buffers = {
                "act_shift": buffers["act_shift"],
                "mask_cache": buffers["mask_cache"][
                    origin[0]:origin[0] + gw, origin[1]:origin[1] + gw]}
            return plane_sweep.sweep_patch_train_win(
                self.model_cfg, params, win_buffers, a, b, viewdirs,
                origin=origin,
                interval=float(stepsize * self.model_cfg.voxel_size_ratio),
                patch=self.sweep_patch, bg=bg, bg_noise=noise)
        if path == "sweep":
            return plane_sweep.sweep_patch_train(
                self.model_cfg, params, buffers, rays_o, rays_d, viewdirs,
                stepsize=stepsize, bg=bg, bg_noise=noise,
                patch=self.sweep_patch, check=False)
        return self.model_mod.forward(
            self.model_cfg, params, buffers, rays_o, rays_d, viewdirs,
            stepsize=stepsize, bg=bg, rand_bkgd=self.rand_bkgd,
            is_train=True, bg_noise=bg_noise, render_depth=True,
            ndc_planes=bool(self.rk.get("ndc_planes", False)))

    def d_condition(self, batch):
        """The discriminator's condition for ``batch`` (None for ``Unet``;
        ``Unet_pose`` reads the view's ``w2c``, the batch's sixth item)."""
        return sr_unetdisc.d_condition(
            self.d_model.kind, batch[2], batch[5], self.patch)

    def loss(self, out, batch):
        """(loss, terms, psnr_sr, rgb_sr, rgb_hr) of a patch render ``out``
        (run_sr.py:884-1011): photometric L1, the generator's L1, the
        perceptual and style terms, the generator's GAN term (the
        discriminator as it is, its vectors left alone), the encoder's
        regularisers."""
        viewdirs, target, target_hr = batch[2:5]
        ct = self.cfg_train
        n_rays = target.shape[0]
        p, r = self.patch, self.sr_ratio
        rgb = out["rgb_feature"]
        loss = ct.weight_main * (rgb - target).abs().mean()
        terms = {"loss_photo": loss}
        rgb_sr = self.sr_model(rgb.reshape(1, p, p, -1),
                               self._condition(out["depth"], viewdirs))
        rgb_hr = target_hr.reshape(1, p * r, p * r, 3)
        loss_sr = (rgb_sr - rgb_hr).abs().mean()
        terms["loss_l1"] = loss_sr
        loss = loss + loss_sr
        psnr_sr = -10.0 * torch.log10(
            ((rgb_sr.detach().clamp(0, 1) - rgb_hr) ** 2).mean())
        if self.perceptual is not None:
            loss_pcp, loss_style = self.perceptual(rgb_sr, rgb_hr)
            terms["loss_pcp"], terms["loss_style"] = loss_pcp, loss_style
            loss = loss + loss_pcp + loss_style
        if self.use_gan:
            fake_g = sr_unetdisc.apply(self.d_model, rgb_sr,
                                       self.d_condition(batch), False)
            loss_g = sr_losses.gan_loss(fake_g, True, is_disc=False,
                                        loss_weight=ct.weight_gan)
            terms["loss_g"] = loss_g
            loss = loss + loss_g
        if ct.weight_entropy_last > 0:
            ent = ct.weight_entropy_last * losses.entropy_last_loss(
                out["alphainv_last"])
            terms["loss_entrp_last"] = ent
            loss = loss + ent
        if ct.weight_distortion > 0:
            ld = ct.weight_distortion * render.distortion_loss(
                out["weights"], out["s"], 1.0 / out["n_max"], n_rays)
            terms["loss_distor"] = ld
            loss = loss + ld
        if ct.weight_rgbper > 0:
            lr_ = ct.weight_rgbper * losses.rgbper(
                out["raw_rgb"], out["weights"], target, n_rays)
            terms["loss_rgbper"] = lr_
            loss = loss + lr_
        return loss, terms, psnr_sr, rgb_sr, rgb_hr

    def loss_and_grads(self, params, buffers, batch, groups, bg_noise=None, *,
                       apply_tv: bool = False, origin=None):
        """(loss, terms, psnr_sr, encoder grads, generator grads, path,
        (rgb_sr, rgb_hr)) of one batch ``(rays_o, rays_d, viewdirs, target,
        target_hr[, w2c])``. The encoder's grads hold the groups named in
        ``groups`` (the density and k0 windows on the window path); the
        generator's are a tree of the flax names (kernels OIHW). The SR
        output comes back detached, for the discriminator's step."""
        rays_o, rays_d, viewdirs = batch[:3]
        path = self.path(params, buffers, apply_tv)
        if path == "window" and origin is None:
            origin = self.window_origin(rays_o, rays_d)
        view = dict(params)
        if path == "window":
            gw = self.grid_window
            for k in ("density", "k0"):
                view[k] = params[k][origin[0]:origin[0] + gw,
                                    origin[1]:origin[1] + gw]
        live = {k: trainer._detached_leaves(view[k]) for k in groups}
        out = self.render({**view, **live}, buffers, rays_o, rays_d, viewdirs,
                          path=path, bg_noise=bg_noise, origin=origin)
        loss, terms, psnr_sr, rgb_sr, rgb_hr = self.loss(out, batch)
        enc_leaves = trainer._flatten(live, [])
        sr_leaves = trainer._flatten(self.sr_params, [])
        grads = torch.autograd.grad(loss, enc_leaves + sr_leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(enc_leaves + sr_leaves, grads)]
        n = len(enc_leaves)
        return (loss.detach(), {k: v.detach() for k, v in terms.items()},
                psnr_sr, trainer._unflatten(live, iter(grads[:n])),
                trainer._unflatten(self.sr_params, iter(grads[n:])),
                (path, origin), (rgb_sr.detach(), rgb_hr))

    def d_loss_and_grads(self, rgb_sr, rgb_hr, cond):
        """The discriminator's loss on the truth and on the (detached) SR
        output, each call updating the spectral-norm vectors, the second
        from the vectors the first left (run_sr.py:1017-1047). Returns
        (loss_d_real, loss_d_fake, grads as a tree of the flax names)."""
        real = sr_unetdisc.apply(self.d_model, rgb_hr, cond, True)
        l_real = sr_losses.gan_loss(real, True, is_disc=True)
        fake = sr_unetdisc.apply(self.d_model, rgb_sr.detach(), cond, True)
        l_fake = sr_losses.gan_loss(fake, False, is_disc=True)
        grads = torch.autograd.grad(l_real + l_fake,
                                    trainer._flatten(self.d_params, []))
        return (l_real.detach(), l_fake.detach(),
                trainer._unflatten(self.d_params, iter(grads)))

    def d_step(self, rgb_sr, rgb_hr, cond, d_opt, lr) -> dict:
        """The discriminator's step: its loss and gradients, then its
        MaskedAdam over ``{"d": ...}`` in place. Returns its terms."""
        l_real, l_fake, grads = self.d_loss_and_grads(rgb_sr, rgb_hr, cond)
        optim.apply_updates({"d": self.d_params}, {"d": grads}, d_opt,
                            {"d": lr})
        return {"loss_d_real": l_real, "loss_d_fake": l_fake}

    @torch.no_grad()
    def add_tv(self, params, grads, tv_dense: bool) -> None:
        """Add the TV gradients of the density and k0 grids, scaled by the
        view count, as the reference's joint loop does
        (run_sr.py:1005-1011)."""
        m, c = self.model_mod, self.model_cfg
        if self.weight_tv_density > 0 and "density" in grads:
            grads["density"].add_(m.density_tv_grad(
                c, params, self.weight_tv_density, tv_dense, self.n_views,
                grads["density"]))
        if self.weight_tv_k0 > 0 and "k0" in grads:
            grads["k0"].add_(m.k0_tv_grad(
                c, params, self.weight_tv_k0, tv_dense, self.n_views,
                grads["k0"]))

    def update(self, params, enc_grads, enc_opt, sr_grads, sr_opt, lrs,
               window) -> None:
        """The encoder's MaskedAdam (on the window at ``window`` where
        given), then the generator's, in place."""
        path, origin = window
        optim.apply_updates(
            params, enc_grads, enc_opt, lrs["enc"],
            skip_zero_grad=self.skip_zero_grad,
            windows={"density": origin, "k0": origin}
            if path == "window" else None)
        optim.apply_updates({"srnet": self.sr_params}, {"srnet": sr_grads},
                            sr_opt, {"srnet": lrs["srnet"]})

    def __call__(self, params, buffers, enc_opt, sr_opt, batch, lrs,
                 bg_noise=None, *, apply_tv: bool, tv_dense: bool,
                 origin=None, d_opt=None):
        """One step; updates ``params``, the generator, the discriminator
        (with a GAN weight: ``d_opt`` its optimizer state, ``lrs["d"]`` its
        lr) and the optimizer states in place. Returns (loss, psnr_sr,
        terms) as device scalars."""
        with fp32_precision(), torch.profiler.record_function("sr_step"):
            loss, terms, psnr_sr, enc_grads, sr_grads, window, sr_hr = \
                self.loss_and_grads(params, buffers, batch, lrs["enc"].keys(),
                                    bg_noise, apply_tv=apply_tv,
                                    origin=origin)
            if apply_tv:
                self.add_tv(params, enc_grads, tv_dense)
            self.update(params, enc_grads, enc_opt, sr_grads, sr_opt, lrs,
                        window)
            if self.use_gan:
                with torch.profiler.record_function("d_step"):
                    terms.update(self.d_step(*sr_hr, self.d_condition(batch),
                                             d_opt, lrs["d"]))
        return loss, psnr_sr, terms


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def save_joint(path, model_mod, model_cfg, params, buffers, sr_model,
               global_step, opt_states: dict | None = None,
               steps_since_reset: int | None = None,
               saver: checkpoints.AsyncSaver | None = None,
               d_model=None) -> None:
    """Write a joint checkpoint in the JAX package's layout (the JAX
    ``_save_joint``): the encoder's params, the generator under ``__sr__``
    (flax names, HWIO), with ``d_model`` the discriminator under
    ``__disc__`` and its vectors under ``__disc_state__``, and the
    optimizer states given (``enc``, ``sr`` and ``d``; None entries left
    out); with ``saver`` in the background."""
    extra = {"pipeline": "joint_sr"}
    if steps_since_reset is not None:
        extra["steps_since_reset"] = int(steps_since_reset)
    tree = dict(params)
    tree["__sr__"] = weights.flax_kernels(weights.sftnet_params(sr_model))
    if d_model is not None:
        tree["__disc__"] = weights.flax_kernels(
            sr_unetdisc.disc_params(d_model))
        tree["__disc_state__"] = weights.flax_kernels(
            sr_unetdisc.disc_spectral(d_model))
    opt = {k: v if k == "enc" else weights.opt_state_to_flax(v)
           for k, v in (opt_states or {}).items() if v is not None} or None
    checkpoints.save_checkpoint(
        path, model_mod.get_kwargs(model_cfg), tree, buffers, opt_state=opt,
        global_step=global_step, extra_meta=extra, saver=saver)


def load_joint(path: str, ndc: bool, device=None):
    """(model_mod, model_cfg, params, buffers, sr_params, d_params,
    d_state, opt_states, global_step, meta) of a joint checkpoint: the
    generator's and the discriminator's params as flax trees of tensors
    (``weights.sftnet_from_flax`` and ``weights.disc_from_flax`` build the
    modules; ``d_params`` None and ``d_state`` empty without a
    discriminator), the optimizer states in the port's layout or None."""
    if not ndc:
        raise trainer._later("the joint trainer's DirectVoxGO branch",
                             "2 (the bounded run.py path)")
    dev = resolve_device(device)
    kwargs, tree, buffers, opt, step, meta = checkpoints.load_checkpoint(
        path, device=dev)
    sr_params = tree.pop("__sr__", None)
    d_params = tree.pop("__disc__", None)
    d_state = tree.pop("__disc_state__", {})
    return (dmpigo, dmpigo.make_config(**kwargs), tree, buffers, sr_params,
            d_params, d_state, _port_opt(opt, dev), step, meta)


def _port_opt(opt, device):
    """A joint file's optimizer states with the generator's and the
    discriminator's moments in the modules' layout (conv kernels OIHW)."""
    if not opt:
        return opt
    return {k: weights.sr_opt_state_from_numpy(v, device)
            if k in ("sr", "d") else v for k, v in opt.items()}


def _periodic_step(path: str, stage: str):
    name = os.path.basename(path)
    if not (name.startswith(f"{stage}_") and name.endswith(".npz")):
        return None
    tail = name[len(stage) + 1:-len(".npz")]
    return int(tail) if tail.isdigit() else None


def find_reload_path(args, rundir: str, stage: str):
    """The checkpoint a joint run starts from: ``--ftdv_path``, else the
    stage's last checkpoint, else the periodic one under ``ckpt_saved/``
    with the largest step (by the parsed integer: ``fine_1000000`` comes
    after ``fine_999999``; temporary files do not parse), else None.
    ``--no_reload`` gives None."""
    if getattr(args, "no_reload", False):
        return None
    if getattr(args, "ftdv_path", ""):
        return args.ftdv_path
    last = os.path.join(rundir, f"{stage}_last.npz")
    if os.path.isfile(last):
        return last
    steps = {p: _periodic_step(p, stage) for p in glob.glob(
        os.path.join(rundir, "ckpt_saved", f"{stage}_*.npz"))}
    steps = {p: s for p, s in steps.items() if s is not None}
    return max(steps, key=steps.get) if steps else None


# ---------------------------------------------------------------------------
# evaluation: full-frame render -> SR decode -> metrics (run_sr.py:1084-1158)
# ---------------------------------------------------------------------------

def _nhwc(srgt) -> np.ndarray:
    srgt = np.asarray(srgt)
    if srgt.ndim == 4 and srgt.shape[1] == 3:  # LLFF keeps NCHW
        srgt = np.moveaxis(srgt, 1, -1)
    return srgt


@fp32_precision()
def evaluate_sr(args, cfg, cfg_model, model_mod, model_cfg, params, buffers,
                sr_model, data_dict, render_kwargs, sr_ratio, split="i_val",
                eval_lpips: bool = True, device=None) -> dict:
    """Render the split's views (scored, float32), decode each in float32
    (in tiles of ``args.test_tile`` when set), and score against the
    high-resolution ground truth: PSNR, SSIM and, with ``eval_lpips``,
    LPIPS (its proxy where the ``lpips`` package is missing). Returns
    ``psnr_sr``, ``ssim_sr``, ``psnr_lr``, ``lpips_sr`` and
    ``lpips_sr_is_proxy`` when scored, ``sr_frames`` (tensors on the
    device) and ``seconds`` by part (render, decode, ssim, lpips; host
    clock)."""
    dev = resolve_device(device)
    idx = data_dict[split]
    sec = {"render": 0.0, "decode": 0.0, "ssim": 0.0, "lpips": 0.0}
    t0 = time.perf_counter()
    data = trainer.DataFlags.from_config(cfg.data)
    res = trainer.render_viewpoints(
        model_mod, model_cfg, params, buffers, data_dict["poses"][idx],
        data_dict["HW"][idx], data_dict["Ks"][idx], data=data,
        render_kwargs=render_kwargs,
        gt_imgs=[np.asarray(data_dict["images"][i]) for i in idx],
        eval_ssim=False, verbose=False, device=dev)
    sec["render"] = time.perf_counter() - t0
    srgt = _nhwc(data_dict["srgt"])[idx]
    num_cond = int(cfg_model.get("num_cond", 1))
    tile = int(getattr(args, "test_tile", 0) or 0)
    psnrs, ssims, lpips_vals, frames = [], [], [], []
    proxy = False
    for fi in range(len(idx)):
        t0 = time.perf_counter()
        feat = res["rgb_features"][fi][None]
        c2w = np.asarray(data_dict["poses"][idx][fi], np.float32)[:3, :4]
        cond = pipeline.sr_condition(num_cond, res["depths"][fi],
                            np.asarray(data_dict["Ks"][idx][fi], np.float32),
                            c2w, data, dev)
        with torch.no_grad():
            if tile:
                sr = sr_esrnet.tile_process(sr_model, feat, cond,
                                            tile_size=tile, scale=sr_ratio)[0]
            else:
                sr = sr_model(feat, cond)[0]
        sr = sr.clamp(0.0, 1.0)
        sr_np = sr.cpu().numpy()
        sec["decode"] += time.perf_counter() - t0
        frames.append(sr)
        gt = srgt[fi]
        gt_dev = torch.as_tensor(np.ascontiguousarray(gt), device=dev)
        psnrs.append(metrics.psnr(sr_np, gt))
        t0 = time.perf_counter()
        ssims.append(metrics.rgb_ssim(sr, gt_dev))
        sec["ssim"] += time.perf_counter() - t0
        if eval_lpips:
            t0 = time.perf_counter()
            lp = metrics.rgb_lpips(gt, sr_np, "vgg")
            if lp is None:
                # the lpips package is absent: the fixed-seed proxy keeps the
                # LPIPS-gated best checkpoint's mechanism (run_sr.py:1150-1156);
                # its values are not comparable to published LPIPS
                proxy = True
                lp = metrics.rgb_lpips_proxy(gt_dev, sr)
            lpips_vals.append(lp)
            sec["lpips"] += time.perf_counter() - t0
    out = {"psnr_sr": float(np.mean(psnrs)), "ssim_sr": float(np.mean(ssims)),
           "sr_frames": frames,
           "psnr_lr": float(np.mean(res["psnrs"])) if res["psnrs"] else None,
           "seconds": sec}
    if lpips_vals:
        out["lpips_sr"] = float(np.mean(lpips_vals))
        out["lpips_sr_is_proxy"] = proxy
    print(f"evaluate_sr: psnr {out['psnr_sr']:.2f} ssim {out['ssim_sr']:.4f}"
          + (f" lpips{'(proxy)' if proxy else ''} {out['lpips_sr']:.4f}"
             if "lpips_sr" in out else ""))
    return out


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

_PATH_NAMES = {"window": "grid-window sweep", "sweep": "full-grid sweep",
               "gather": "gather forward"}


def build_perceptual(cfg_train, stage: str = "fine", device=None):
    """The perceptual and style loss of a config with ``weight_pcp > 0``,
    else None. It needs pretrained VGG19 weights (a torchvision
    ``vgg19*.pth`` where :func:`sr_losses.find_vgg19_weights` looks):
    training another objective than the config declares is worse than
    refusing to start (the reference wires basicsr's PerceptualLoss
    whenever ``weight_pcp > 0``, run_sr.py:670-678). Two explicit escape
    hatches: ``allow_missing_vgg`` drops the term, ``allow_random_vgg``
    runs it on the fixed-seed random tower (not the published VGG)."""
    if not cfg_train.get("weight_pcp", 0) > 0:
        return None
    try:
        perceptual = sr_losses.PerceptualLoss(
            perceptual_weight=cfg_train.weight_pcp,
            style_weight=cfg_train.get("weight_style", 0),
            allow_random_vgg=cfg_train.get("allow_random_vgg", False),
            device=device)
        if (cfg_train.get("allow_random_vgg", False)
                and sr_losses.find_vgg19_weights() is None):
            print(f"sr ({stage}): WARNING perceptual/style loss running on "
                  "the fixed-seed RANDOM VGG tower (allow_random_vgg; no "
                  "pretrained weights found)")
        return perceptual
    except FileNotFoundError as e:
        if cfg_train.get("allow_missing_vgg", False):
            print(f"sr ({stage}): WARNING perceptual loss DISABLED by "
                  f"allow_missing_vgg; objective differs from config ({e})")
            return None
        raise RuntimeError(
            f"config sets weight_pcp={cfg_train.weight_pcp} but no "
            "pretrained VGG19 weights were found. Provide a torchvision "
            "vgg19 .pth (see README 'VGG19 weights contract') or set "
            "fine_train.allow_missing_vgg=True to train without the "
            "perceptual term.") from e


def build_discriminator(cfg_model, hr_patch: int, seed: int, device=None):
    """The discriminator a config names (``d_model``: ``Unet``,
    ``Unet_pose`` or ``Unet_viewdir``, run_sr.py:681-686) at 64 features
    for ``hr_patch``-pixel patches, drawn by flax's initialisers from a
    ``torch.Generator`` seeded with ``seed + 1`` (the generator's draws
    take ``seed``)."""
    d_model = sr_unetdisc.build(
        str(cfg_model.get("d_model", "Unet")), 64,
        sr_unetdisc.fc_in_for(64, (hr_patch, hr_patch)))
    sr_unetdisc.init_like_flax(d_model, torch.Generator().manual_seed(
        seed + 1))
    return d_model.to(resolve_device(device))


def _inmask_patches(model_cfg, buffers, flat, patch: int, stepsize: float):
    """[n_combos] bool: whether any ray of a sampler patch meets the
    occupancy cache (the 'patch_inmask' filter, lib/dvgo.py:786-820)."""
    V, H, W = flat["rgb"].shape[:3]
    rows, cols = patch_origins(H, W, patch)
    K_s = model_cfg.n_samples(stepsize)
    dev = flat["rgb"].device
    mn = torch.tensor(model_cfg.xyz_min, dtype=torch.float32, device=dev)
    mx = torch.tensor(model_cfg.xyz_max, dtype=torch.float32, device=dev)
    hits = []
    for v in range(V):
        ro = flat["rays_o"][v].reshape(-1, 3)
        rd = flat["rays_d"][v].reshape(-1, 3)
        hv = []
        for s in range(0, ro.shape[0], 1 << 14):
            pts = render.sample_ndc_pts_on_rays(ro[s:s + (1 << 14)],
                                                rd[s:s + (1 << 14)], K_s)
            ok = ((pts >= mn) & (pts <= mx)).all(-1)
            ok &= grid_sample.nearest_mask_lookup(buffers["mask_cache"], pts,
                                                  mn, mx)
            hv.append(ok.any(-1))
        hv = torch.cat(hv).reshape(H, W).cpu().numpy()
        hits += [bool(hv[r:r + patch, c:c + patch].any())
                 for r in rows for c in cols]
    return np.asarray(hits)


def scene_rep_reconstruction_sr_patch(args, cfg, cfg_model, cfg_train,
                                      xyz_min, xyz_max, data_dict,
                                      stage: str, writer=None, device=None):
    """Train the encoder and the generator (and, with a GAN weight, the
    discriminator) jointly on ``device`` (default ``cuda``). Returns
    (model_mod, model_cfg, params, buffers, sr_model)."""
    dev = resolve_device(device)
    model_mod = trainer._select_model_mod(cfg)
    if abs(cfg_model.world_bound_scale - 1) > 1e-9:
        xyz_shift = (xyz_max - xyz_min) * (cfg_model.world_bound_scale - 1) / 2
        xyz_min, xyz_max = xyz_min - xyz_shift, xyz_max + xyz_shift
    i_train, i_val = data_dict["i_train"], data_dict["i_val"]
    sr_ratio = int(cfg.data.factor / cfg.data.load_sr) \
        if cfg.data.load_sr else 4
    seed = int(getattr(args, "seed", 777))
    patch = int(cfg_train.get("N_patch", 64))
    rundir = os.path.join(cfg.basedir, cfg.expname)
    last_ckpt_path = os.path.join(rundir, f"{stage}_last.npz")

    # --- encoder: reload (pretrained / joint resume) or new -----------------
    start, loaded_sr, loaded_d, loaded_d_state = 0, None, None, None
    opt_l, meta_l = {}, {}
    reload_path = find_reload_path(args, rundir, stage)
    if reload_path:
        print(f"sr ({stage}): reload encoder from {reload_path}")
        if reload_path.endswith(".tar"):
            kwargs_l, p_np, b_np, start = \
                checkpoints.import_torch_encoder_checkpoint(reload_path)
            params, buffers = weights.dmpigo_from_numpy(p_np, b_np, dev)
        else:
            kwargs_l, params, buffers, opt_raw, start, meta_l = \
                checkpoints.load_checkpoint(reload_path, device=dev)
            if meta_l.get("pipeline") == "joint_sr":
                # the generator and the discriminator ride in the encoder's
                # tree of a joint file
                loaded_sr = params.pop("__sr__", None)
                loaded_d = params.pop("__disc__", None)
                loaded_d_state = params.pop("__disc_state__", None)
                opt_l = _port_opt(opt_raw, dev) or {}
        model_cfg = model_mod.make_config(**kwargs_l)
    else:
        model_kwargs = dict(cfg_model)
        num_voxels = model_kwargs.pop("num_voxels")
        if len(cfg_train.pg_scale):
            num_voxels = int(num_voxels / (2 ** len(cfg_train.pg_scale)))
        model_cfg = trainer._make_cfg(model_mod, xyz_min, xyz_max, num_voxels,
                                      model_kwargs)
        params, buffers = model_mod.init(
            model_cfg, generator=torch.Generator().manual_seed(seed),
            device=dev)

    # --- the generator -------------------------------------------------------
    num_cond = int(cfg_model.get("num_cond", 1))
    sr_model = sr_esrnet.SFTNet(
        n_in_colors=int(cfg_model.dim_rend), scale=sr_ratio, num_feat=64,
        num_block=5, num_grow_ch=32, num_cond=num_cond)
    sr_esrnet.init_like_jax(sr_model, torch.Generator().manual_seed(seed))
    sr_model = sr_model.to(dev)
    if loaded_sr is not None:
        weights._load_flax_convs(sr_model, loaded_sr)
        print(f"sr ({stage}): restored SR generator from joint checkpoint")
    elif getattr(args, "ftsr_path", ""):
        sd = checkpoints._torch_load(args.ftsr_path)
        for pk in ("params_ema", "params"):
            if isinstance(sd, dict) and pk in sd:
                sd = sd[pk]
                break
        sr_esrnet.load_reference_state_dict(sr_model, sd)
        print(f"sr ({stage}): imported SR init from {args.ftsr_path}")

    # --- losses and the discriminator ---------------------------------------
    perceptual = build_perceptual(cfg_train, stage, dev)
    d_model = None
    if cfg_train.get("weight_gan", 0) > 0:
        d_model = build_discriminator(cfg_model, patch * sr_ratio, seed, dev)
        if loaded_d is not None:
            weights.load_disc_flax(d_model, loaded_d, loaded_d_state)
            print(f"sr ({stage}): restored discriminator from joint "
                  "checkpoint")

    render_kwargs = {
        "near": float(data_dict["near"]), "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "rand_bkgd": bool(cfg.data.rand_bkgd),
        "stepsize": float(cfg_model.stepsize),
    }
    render_kwargs["ndc_planes"] = dmpigo.plane_aligned_ok(
        model_cfg, render_kwargs["stepsize"], cfg.data.ndc)

    # --- rays (image layout) and the aligned HR targets ----------------------
    flat, _ = trainer.gather_training_rays(
        cfg, _force_image_sampler(cfg_train), data_dict, dev)
    V, H, W = flat["rgb"].shape[:3]
    dev_hr = torch.as_tensor(
        np.ascontiguousarray(_nhwc(data_dict["srgt"])[i_train]),
        dtype=torch.float32, device=dev)  # [V, H*r, W*r, 3]
    inmask = None
    if str(cfg_train.get("ray_sampler", "")) == "patch_inmask":
        inmask = _inmask_patches(model_cfg, buffers, flat, patch,
                                 render_kwargs["stepsize"])
        print(f"sr: patch_inmask keeps {int(inmask.sum())}/{len(inmask)} "
              "patches")
    sample_patch = make_patch_sampler(V, H, W, patch, seed, inmask=inmask)

    def compute_sweep_patch(mcfg):
        """The sweep's slice size and grid window at the current grid size
        (None where they do not fit), and the host copies of the rays'
        affine coefficients that the window origins come from."""
        if not render_kwargs["ndc_planes"]:
            return None, None, None
        X, Y, Z = mcfg.world_size
        sizes = torch.tensor([X, Y], dtype=torch.float32, device=dev)
        mn = torch.tensor(mcfg.xyz_min, dtype=torch.float32, device=dev)
        mx = torch.tensor(mcfg.xyz_max, dtype=torch.float32, device=dev)
        a_all, b_all = (t.cpu().numpy() for t in plane_sweep.affine_coeffs(
            flat["rays_o"], flat["rays_d"], mn, mx, sizes, Z))
        rows, cols = sample_patch.rows, sample_patch.cols
        sp = sweep_patch_size_for(mcfg, a_all, b_all, rows, cols, patch)
        gw = (sweep_window_size_for(mcfg, a_all, b_all, rows, cols, patch, sp)
              if sp is not None else None)
        print(f"sr: plane-sweep patch rendering "
              f"{'ON (slice ' + str(sp) + ')' if sp else 'OFF (footprint too large)'}"
              f"{', grid window ' + str(gw) if gw else ''}"
              f" at world_size {tuple(mcfg.world_size)}")
        return sp, gw, (a_all, b_all)

    def make_step(mcfg):
        sp, gw, ab = compute_sweep_patch(mcfg)
        st = SRTrainStep(model_mod, mcfg, cfg_train, cfg_model,
                         render_kwargs=render_kwargs,
                         skip_zero_grad=skip_zero, sr_model=sr_model,
                         n_views=V, patch=patch, sr_ratio=sr_ratio,
                         sweep_patch=sp, grid_window=gw,
                         perceptual=perceptual, d_model=d_model)
        mask = tuple(buffers["mask_cache"].shape)
        print(f"sr: steps without TV take the "
              f"{_PATH_NAMES[st.path(params, buffers, apply_tv=False)]}, the "
              f"mask {mask} read in "
              f"{'CHANNEL' if mask == tuple(mcfg.world_size) else 'NATIVE'}"
              " mode")
        return st, ab

    # --- optimizers ----------------------------------------------------------
    base_lrs = optim.build_group_lrs(cfg_train, params)
    skip_zero = frozenset(cfg_train.skip_zero_grad_fields)
    enc_opt = optim.init_state(params)
    sr_opt = optim.init_state({"srnet": weights.sftnet_params(sr_model)})
    d_opt = (optim.init_state({"d": sr_unetdisc.disc_params(d_model)})
             if d_model is not None else None)
    if not getattr(args, "no_reload_optimizer", False) and opt_l:
        enc_opt, r1 = optim.restore_state(opt_l.get("enc"), enc_opt,
                                          label="encoder opt")
        sr_opt, r2 = optim.restore_state(opt_l.get("sr"), sr_opt,
                                         label="srnet opt")
        if d_opt is not None:
            d_opt, _ = optim.restore_state(opt_l.get("d"), d_opt,
                                           label="disc opt")
        if r1 or r2:
            print(f"sr ({stage}): restored optimizer state from joint "
                  "checkpoint")
    del opt_l
    lr_srnet0 = float(cfg_train.get("lrate_srnet", 2e-4))
    step_fn, ab = make_step(model_cfg)

    # the views' w2c rotations, the pose discriminator's condition
    w2c_train = torch.as_tensor(np.asarray(data_dict.get(
        "w2c", np.zeros((len(data_dict["poses"]), 3, 3))))[i_train],
        dtype=torch.float32, device=dev)

    def gather(v: int, r: int, c: int):
        def sl(t):
            return t[v, r:r + patch, c:c + patch].reshape(-1, 3)
        hr = dev_hr[v, r * sr_ratio:(r + patch) * sr_ratio,
                    c * sr_ratio:(c + patch) * sr_ratio].reshape(-1, 3)
        return (sl(flat["rays_o"]), sl(flat["rays_d"]), sl(flat["viewdirs"]),
                sl(flat["rgb"]), hr, w2c_train[v])

    def window_origin(v: int, r: int, c: int):
        X, Y, Z = model_cfg.world_size
        a = torch.from_numpy(ab[0][v, r:r + patch, c:c + patch].reshape(-1, 2))
        b = torch.from_numpy(ab[1][v, r:r + patch, c:c + patch].reshape(-1, 2))
        return plane_sweep.sweep_window_origin(a, b, Z, X, Y,
                                               step_fn.grid_window)

    collector = stats_mod.Collector()
    best_lpips, best_psnr = np.inf, -np.inf
    if "steps_since_reset" in meta_l:
        steps_since_reset = int(meta_l["steps_since_reset"])
    else:
        prior = [b for b in cfg_train.pg_scale if b <= start]
        steps_since_reset = start - (max(prior) if prior else 0)
    time0 = time.time()
    saver = checkpoints.AsyncSaver()
    try:
        for global_step in range(1 + start, 1 + cfg_train.N_iters):
            if (global_step + 500) % 1000 == 0:
                buffers = model_mod.update_occupancy_cache(model_cfg, params,
                                                           buffers)
            if global_step in cfg_train.pg_scale:
                n_rest = (len(cfg_train.pg_scale)
                          - cfg_train.pg_scale.index(global_step) - 1)
                cur_voxels = int(cfg_model.num_voxels / (2 ** n_rest))
                enc_opt = None  # the old moments go before the grids grow
                model_cfg, params, buffers = dmpigo.scale_volume_grid(
                    model_cfg, params, buffers, cur_voxels,
                    model_cfg.mpi_depth)
                buffers = dmpigo.decay_act_shift(buffers,
                                                 cfg_train.decay_after_scale)
                enc_opt = optim.init_state(params)
                steps_since_reset = 0
                # the grid grew: re-derive the slice and the window (a stale
                # size would read zeros), or drop the sweep
                step_fn, ab = make_step(model_cfg)

            v, r, c = sample_patch(global_step - 1)
            batch = gather(v, r, c)

            def decayed(lr0):
                return optim.group_lr(lr0, steps_since_reset,
                                      cfg_train.lrate_decay)

            lrs = {"enc": {k: decayed(v0) for k, v0 in base_lrs.items()},
                   "srnet": decayed(lr_srnet0), "d": decayed(lr_srnet0)}
            noise = (trainer.bkgd_noise(seed, global_step, patch * patch, dev)
                     if render_kwargs["rand_bkgd"] else None)
            apply_tv = (cfg_train.tv_after < global_step < cfg_train.tv_before
                        and global_step % cfg_train.tv_every == 0)
            origin = (window_origin(v, r, c) if step_fn.path(
                params, buffers, bool(apply_tv)) == "window" else None)
            _, psnr_sr, terms = step_fn(
                params, buffers, enc_opt, sr_opt, batch, lrs, noise,
                apply_tv=bool(apply_tv),
                tv_dense=bool(global_step < cfg_train.tv_dense_before),
                origin=origin, d_opt=d_opt)
            steps_since_reset += 1
            collector.report("train/psnr_sr", stats_mod.moments(psnr_sr))
            for k, t in terms.items():
                collector.report(f"train/{k}", stats_mod.moments(t))

            if args.i_print and global_step % args.i_print == 0:
                means = {k: st.mean
                         for k, st in sorted(collector.as_dict().items())}
                print(f"sr ({stage}): iter {global_step:6d} / " + " ".join(
                    f"{k.removeprefix('train/')}: {v_:.6f}"
                    for k, v_ in means.items() if k != "train/psnr_sr")
                    + f" / PSNR_SR: {means['train/psnr_sr']:5.2f} / Eps: "
                    f"{time.time() - time0:.0f}s", flush=True)
                if writer is not None:
                    for k, v_ in means.items():
                        writer.scalar(k, v_, global_step)
                collector.reset()

            if args.i_val and global_step % args.i_val == 0 and len(i_val):
                val = evaluate_sr(args, cfg, cfg_model, model_mod, model_cfg,
                                  params, buffers, sr_model, data_dict,
                                  render_kwargs, sr_ratio, device=dev)
                is_proxy = bool(val.get("lpips_sr_is_proxy"))
                if writer is not None:
                    for k, vv in val.items():
                        if isinstance(vv, float):
                            name = ("lpips_sr_proxy"
                                    if k == "lpips_sr" and is_proxy else k)
                            writer.scalar(f"val/{name}", vv, global_step)
                gate = val.get("lpips_sr")
                if best_psnr == -np.inf:  # the first val: name the gate once
                    if gate is None:
                        print(f"sr ({stage}): WARNING lpips unavailable -- "
                              "best checkpoint gated on PSNR instead of LPIPS "
                              "(reference gates on LPIPS)")
                    elif is_proxy:
                        print(f"sr ({stage}): best checkpoint gated on the "
                              "deterministic random-feature LPIPS PROXY "
                              "(torch lpips package absent; values not "
                              "comparable to published LPIPS)")
                improved = (gate is not None and gate < best_lpips) or (
                    gate is None and val["psnr_sr"] > best_psnr)
                if improved:
                    best_lpips = gate if gate is not None else best_lpips
                    best_psnr = max(best_psnr, val["psnr_sr"])
                    save_joint(os.path.join(rundir, "render_val",
                                            "best_joint.npz"),
                               model_mod, model_cfg, params, buffers,
                               sr_model, global_step, saver=saver,
                               d_model=d_model)
                del val

            if args.i_weights and global_step % args.i_weights == 0:
                save_joint(os.path.join(rundir, "ckpt_saved",
                                        f"{stage}_{global_step:06d}.npz"),
                           model_mod, model_cfg, params, buffers, sr_model,
                           global_step,
                           opt_states={"enc": enc_opt, "sr": sr_opt,
                                       "d": d_opt},
                           steps_since_reset=steps_since_reset, saver=saver,
                           d_model=d_model)
                print(f"sr ({stage}): async checkpoint dispatched at iter "
                      f"{global_step}", flush=True)

        saver.wait_for_pending_saves()
        if cfg_train.N_iters > start:
            save_joint(last_ckpt_path, model_mod, model_cfg, params, buffers,
                       sr_model, cfg_train.N_iters,
                       opt_states={"enc": enc_opt, "sr": sr_opt,
                                   "d": d_opt},
                       steps_since_reset=steps_since_reset, d_model=d_model)
            print(f"sr ({stage}): saved checkpoint at {last_ckpt_path}")
    finally:
        saver.close()
    return model_mod, model_cfg, params, buffers, sr_model


def train_sr(args, cfg, data_dict, writer=None, device=None):
    """Fit a scene jointly (run_sr.py): the box from the training cameras'
    frustums, then :func:`scene_rep_reconstruction_sr_patch` of the fine
    stage on ``device`` (default ``cuda``)."""
    os.makedirs(os.path.join(cfg.basedir, cfg.expname), exist_ok=True)
    xyz_min, xyz_max = trainer.compute_bbox_by_cam_frustrm(
        cfg, data_dict["HW"], data_dict["Ks"], data_dict["poses"],
        data_dict["i_train"], data_dict["near"], data_dict["far"],
        near_clip=data_dict.get("near_clip"), device=device)
    return scene_rep_reconstruction_sr_patch(
        args, cfg, cfg.fine_model_and_render, cfg.fine_train, xyz_min,
        xyz_max, data_dict, stage="fine", writer=writer, device=device)
