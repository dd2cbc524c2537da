"""Port parity of the joint trainer's DirectVoxGO branch (the chair joint
config, ``configs/syn/chair_joint_1x_l1_gan.py``) against the JAX package.

One step. ``make_sr_train_step(donate=False)`` on a DirectVoxGO encoder
(14^3 grid, 6-ch k0, rgbnet 3x16, numpy-drawn), its 16-pixel patch
rendered by ``dvgo.forward`` (the gather forward: the plane sweep is for
NDC scenes), the scale-1 SFTNet of the chair config (16 features, one
RRDB), ``weight_gan``, ``weight_pcp`` and ``weight_style`` on with the
synthetic VGG tower of ``tests/test_torch_sr_gan.py`` and the ``Unet``
discriminator at ``num_feat`` 8; with and without TV (the dvgo TV
gradients, scaled by the view count); the port's step from the same
state.

And ``--ftdvcoa_path``: ``train_sr`` tightens the box to the coarse
checkpoint's geometry and starts the new encoder from its mask, as the
JAX package's ``run_sr.py`` and joint trainer do; ``run_sr.main`` trains
the chair config (cut: a 16^3 grid that doubles at step 2, 16-pixel
patches, ``allow_random_vgg``) on a tiny Blender scene on the CPU and
serves from its file.

Tolerances. The loss and every term 1e-5 relative; gradients, read from
the first moments after one step from a zero state, within 1e-5 of each
leaf's largest entry (for the discriminator's leaves the largest entry of
``|g_real| + |g_fake|`` if larger: its last bias is a difference of two
means), the rgbnet's within 5e-5 (sums over the patch's 256 rays of
~450 samples each, through the generator's gradient: measured 1.6e-5);
second moments twice that; params after MaskedAdam at most two
entries or 1e-3 of a leaf off by more than 1e-4 (the first move is ``lr *
sign(g)``); the vectors ``u`` 1e-5. The box and the mask of
``--ftdvcoa_path`` equal."""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict
from fourk_nerf_tpu.models import dvgo as jd, sr_esrnet as jsr, \
    sr_unetdisc as jdisc
from fourk_nerf_tpu.ops import grid_sample as jgs, rays as jrays
from fourk_nerf_tpu.train import checkpoints as jc, optim as jo, \
    sr_losses as jl, sr_trainer as jst, trainer as jt
from fourk_nerf_torch import config as tconfig, run_sr, weights
from fourk_nerf_torch.models import dvgo as td, sr_unetdisc as tdisc
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import optim as to, sr_losses as tl, \
    sr_trainer as tst
from test_torch_bounded_train import _write_blender
from test_torch_sr_gan import GAN, LAYERS, _few_off, _vgg_flax
from test_torch_sr_step import LRS, _cfg_train, _flat

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "syn", "chair_joint_1x_l1_gan.py")
PATCH = 16
RK = dict(near=2.0, far=6.0, bg=1.0, stepsize=0.5, rand_bkgd=False)
CFG_MODEL = ConfigDict(dict(num_cond=1, dim_rend=3, d_model="Unet"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(rng):
    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        if name == "u":
            return rng.normal(0, 1, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, np.sqrt(1.0 / fan_in), leaf.shape).astype(
            np.float32)
    return draw


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    cfg = jd.make_config(xyz_min=[-1.6] * 3, xyz_max=[1.6] * 3,
                         num_voxels=14 ** 3, num_voxels_base=14 ** 3,
                         alpha_init=1e-2, rgbnet_dim=6, rgbnet_width=16,
                         fast_color_thres=1e-4)
    params, _ = jd.init(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    params["density"] = rng.normal(-1, 2, params["density"].shape).astype(
        np.float32)
    params["k0"] = rng.normal(0, 1, params["k0"].shape).astype(np.float32)
    for k, v in params["rgbnet"].items():
        params["rgbnet"][k] = rng.normal(
            0, 0.1 if k[0] == "b" else 1 / np.sqrt(v.shape[0]),
            v.shape).astype(np.float32)
    buffers = {"mask_cache": rng.uniform(size=cfg.world_size) < 0.8}
    sr_model = jsr.SFTNet(n_in_colors=3, scale=1, num_feat=16, num_block=1,
                          num_grow_ch=8, num_cond=1)
    sr_params = jax.tree_util.tree_map_with_path(_draw(rng), jax.eval_shape(
        sr_model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, PATCH, PATCH, 3)),
        jnp.zeros((1, PATCH, PATCH, 1)))["params"])
    d_model = jdisc.UNetDiscriminatorSN(num_feat=8)
    dv = jax.tree_util.tree_map_with_path(_draw(rng), jax.eval_shape(
        d_model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, PATCH, PATCH, 3))))
    c2w = tiny_scene.bounded_poses(3)[2]
    f = tiny_scene.blender_focal(32)
    K = np.array([[f, 0, 16], [0, f, 16], [0, 0, 1]], np.float32)
    rays = jrays.get_rays_of_a_view(32, 32, K, c2w, ndc=False,
                                    inverse_y=False, flip_x=False,
                                    flip_y=False)
    ro, rd, vd = (np.asarray(x)[9:9 + PATCH, 5:5 + PATCH].reshape(-1, 3)
                  for x in rays)
    target = rng.uniform(0, 1, (PATCH * PATCH, 3)).astype(np.float32)
    hr = rng.uniform(0, 1, (PATCH * PATCH, 3)).astype(np.float32)
    return dict(cfg=cfg, params=params, buffers=buffers, sr_model=sr_model,
                sr_params=sr_params, d_model=d_model, d_params=dv["params"],
                d_state=dv["spectral"], vgg=_vgg_flax(rng),
                batch=(ro, rd, vd, target, hr))


def _jax_step(sc, apply_tv):
    perceptual = jl.PerceptualLoss(layer_weights=LAYERS,
                                   perceptual_weight=0.5, style_weight=0.2,
                                   vgg_params=sc["vgg"])
    step = jst.make_sr_train_step(
        jd, sc["cfg"], _cfg_train(N_patch=PATCH, **GAN), CFG_MODEL,
        render_kwargs=RK, skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=sc["sr_model"], d_model=sc["d_model"], n_views=4,
        patch=PATCH, sr_ratio=1, perceptual=perceptual, d_kind="Unet",
        donate=False)
    params = jax.tree.map(jnp.asarray, sc["params"])
    sr_params = jax.tree.map(jnp.asarray, sc["sr_params"])
    out = step(params, {"mask_cache": jnp.asarray(sc["buffers"]
                                                  ["mask_cache"])},
               jo.init_state(params), sr_params,
               jo.init_state({"srnet": sr_params}), sc["d_params"],
               sc["d_state"], jo.init_state({"d": sc["d_params"]}),
               tuple(jnp.asarray(a) for a in sc["batch"]) + (jnp.eye(3),),
               LRS, jax.random.PRNGKey(7), sc["vgg"], apply_tv=apply_tv,
               tv_dense=True)
    p, eo, sp, so, dp, ds, do = (jax.tree.map(np.asarray, x)
                                 for x in out[:7])
    return dict(params=p, enc_opt=eo, sr_params=sp, sr_opt=so, d_params=dp,
                d_state=ds, d_opt=do, loss=float(out[7]),
                terms={k: float(v) for k, v in out[9].items()})


def _port_setup(sc):
    mcfg = td.make_config(**jd.get_kwargs(sc["cfg"]))
    params, buffers = weights.dvgo_from_numpy(sc["params"], sc["buffers"],
                                              "cpu")
    sr_model = weights.sftnet_from_flax(sc["sr_params"], device="cpu")
    d_model = weights.disc_from_flax(sc["d_params"], sc["d_state"],
                                     device="cpu")
    perceptual = tl.PerceptualLoss(
        layer_weights=LAYERS, perceptual_weight=0.5, style_weight=0.2,
        vgg_params=weights.vgg19_from_flax(sc["vgg"], "cpu"), device="cpu")
    step = tst.SRTrainStep(
        td, mcfg, _cfg_train(N_patch=PATCH, **GAN), CFG_MODEL,
        render_kwargs=RK, skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=sr_model, n_views=4, patch=PATCH, sr_ratio=1,
        perceptual=perceptual, d_model=d_model)
    batch = tuple(torch.as_tensor(a) for a in sc["batch"]) + (torch.eye(3),)
    return step, params, buffers, batch


def _d_part_scales(sc) -> dict:
    """For each discriminator leaf (flax layout), the largest entry of
    ``|g_real| + |g_fake|`` before the step."""
    step, params, buffers, batch = _port_setup(sc)
    *_, (rgb_sr, rgb_hr) = step.loss_and_grads(params, buffers, batch,
                                               LRS["enc"].keys())
    leaves = [p for _, p in step.d_model.named_parameters()]
    parts = []
    for x, real in ((rgb_hr, True), (rgb_sr, False)):
        out = tdisc.apply(step.d_model, x, None, True)
        parts.append(torch.autograd.grad(
            tl.gan_loss(out, real, is_disc=True), leaves, allow_unused=True))
    size = tdisc._tree(
        (n, sum(torch.zeros_like(p) if q is None else q.abs() for q in qs))
        for (n, p), qs in zip(step.d_model.named_parameters(), zip(*parts)))
    return {f"d/d/{k}": float(np.abs(v).max()) for k, v in
            _flat(weights.flax_kernels(size)).items()}


@pytest.mark.parametrize("apply_tv", [False, True])
def test_dvgo_joint_gan_step_matches_jax(scene, apply_tv):
    want = _jax_step(scene, apply_tv)
    step, params, buffers, batch = _port_setup(scene)
    assert step.path(params, buffers, apply_tv) == "gather"
    enc_opt = to.init_state(params)
    sr_opt = to.init_state({"srnet": weights.sftnet_params(step.sr_model)})
    d_opt = to.init_state({"d": tdisc.disc_params(step.d_model)})
    loss, _, terms = step(params, buffers, enc_opt, sr_opt, batch, LRS,
                          apply_tv=apply_tv, tv_dense=True, d_opt=d_opt)
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    assert set(terms) == set(want["terms"])
    assert {"loss_pcp", "loss_style", "loss_g", "loss_d_real",
            "loss_d_fake"} <= set(terms)
    for k, v in want["terms"].items():
        np.testing.assert_allclose(terms[k].item(), v, rtol=1e-5, err_msg=k)
    parts = _d_part_scales(scene)
    d_flax = weights.opt_state_to_flax(d_opt)
    for moment, scale in (("exp_avg", 1), ("exp_avg_sq", 2)):
        gm = {**_flat(enc_opt[moment], "enc/"),
              **_flat(weights.flax_kernels(sr_opt[moment]), "sr/"),
              **_flat(d_flax[moment], "d/")}
        wm = {**_flat(want["enc_opt"][moment], "enc/"),
              **_flat(want["sr_opt"][moment], "sr/"),
              **_flat(want["d_opt"][moment], "d/")}
        assert set(gm) == set(wm)
        for k, w in wm.items():
            ref = np.abs(w).max()
            if k in parts:
                ref = max(ref, 0.1 * parts[k] if moment == "exp_avg"
                          else 0.01 * parts[k] ** 2)
            assert ref > 0, k
            tol = 5e-5 if k.startswith("enc/rgbnet") else 1e-5
            np.testing.assert_allclose(gm[k], w, rtol=0,
                                       atol=scale * tol * ref,
                                       err_msg=f"{moment} {k}")
    dp, ds = weights.disc_to_flax(step.d_model)
    gp = {**_flat(params, "enc/"),
          **_flat(weights.sftnet_to_flax(step.sr_model), "sr/"),
          **_flat(dp, "d/")}
    wp = {**_flat(want["params"], "enc/"), **_flat(want["sr_params"], "sr/"),
          **_flat(want["d_params"], "d/")}
    assert set(gp) == set(wp)
    for k, w in wp.items():
        _few_off(gp[k], w, k)
    for k, w in _flat(want["d_state"]).items():
        np.testing.assert_allclose(_flat(ds)[k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


def _coarse(path):
    """A coarse DirectVoxGO file over the tiny scene's box: density high in
    two balls of radius 0.45, empty between."""
    cfg = jd.make_config(xyz_min=[-2.2] * 3, xyz_max=[2.2] * 3,
                         num_voxels=24 ** 3, num_voxels_base=24 ** 3,
                         alpha_init=1e-2, rgbnet_dim=0)
    g = np.stack(np.meshgrid(*[np.linspace(-2.2, 2.2, n)
                               for n in cfg.world_size], indexing="ij"), -1)
    ball = ((((g - (-1.0, 0.0, 0.0)) ** 2).sum(-1) < 0.45 ** 2)
            | (((g - (1.0, 0.6, 0.0)) ** 2).sum(-1) < 0.45 ** 2))
    dens = np.where(ball, 5.0, -20.0)[..., None]
    params = {"density": dens.astype(np.float32),
              "k0": np.zeros((*cfg.world_size, 3), np.float32)}
    jc.save_checkpoint(path, jd.get_kwargs(cfg), params,
                       {"mask_cache": np.ones(cfg.world_size, bool)},
                       global_step=60)


def _chair_cfg(tmp, scene_dir):
    path = tmp / "chair.py"
    path.write_text(
        f"_base_ = {os.path.join(ROOT, 'fourk_nerf_torch', CFG)!r}\n"
        f"expname = 'chair'\nbasedir = {str(tmp / 'logs')!r}\n"
        f"data = dict(datadir={str(scene_dir)!r})\n"
        "fine_train = dict(N_iters=3, N_patch=16, pg_scale=[2], "
        "allow_random_vgg=True)\n"
        "fine_model_and_render = dict(num_voxels=16 ** 3, "
        "num_voxels_base=16 ** 3, rgbnet_width=16)\n")
    return str(path)


def test_ftdvcoa_path_box_and_mask_match_jax(tmp_path):
    coarse = str(tmp_path / "coarse_last.npz")
    _coarse(coarse)
    data = tiny_scene.bounded_scene(h=32, w=32)
    cfg = tconfig.load_config(_chair_cfg(tmp_path, tmp_path / "none"))
    cfg.fine_train.N_iters = 0
    args = types.SimpleNamespace(seed=777, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 ftdv_path="", ftdvcoa_path=coarse,
                                 ftsr_path="", i_print=0, i_val=0,
                                 i_weights=0)
    _, mcfg, _, buffers, _ = tst.train_sr(args, cfg, data, device="cpu")
    # the JAX package's bootstrap (run_sr.py:91-102, sr_trainer.py:424-450)
    lo, hi = jt.compute_bbox_by_coarse_geo(jd, coarse, 1e-3)
    shift = (hi - lo) * (1.05 - 1) / 2
    want_cfg = jd.make_config(
        xyz_min=lo - shift, xyz_max=hi + shift, num_voxels=16 ** 3 // 2,
        num_voxels_base=16 ** 3, alpha_init=1e-2)
    assert mcfg.xyz_min == want_cfg.xyz_min
    assert mcfg.xyz_max == want_cfg.xyz_max
    assert mcfg.world_size == want_cfg.world_size
    mask, m_min, m_max = jc.mask_from_coarse_checkpoint(coarse, 1e-3)
    xyz = np.stack(np.meshgrid(*[np.linspace(
        want_cfg.xyz_min[d], want_cfg.xyz_max[d], want_cfg.world_size[d])
        for d in range(3)], indexing="ij"), -1)
    want = np.asarray(jgs.nearest_mask_lookup(
        jnp.asarray(mask), jnp.asarray(xyz, jnp.float32),
        jnp.asarray(m_min, jnp.float32), jnp.asarray(m_max, jnp.float32)))
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(buffers["mask_cache"].numpy(), want)


def test_run_sr_trains_the_chair_config_and_serves(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    coarse = str(tmp_path / "coarse_last.npz")
    _coarse(coarse)
    scene_dir = tmp_path / "scene"
    _write_blender(str(scene_dir), tiny_scene.bounded_scene(h=32, w=32))
    base = ["--config", _chair_cfg(tmp_path, scene_dir), "--device", "cpu",
            "--i_print", "1", "--i_val", "0", "--i_weights", "0"]
    trained = run_sr.main(base + ["--ftdvcoa_path", coarse, "--render_test"])
    model_mod, mcfg, _, buffers, sr_model = trained["model"]
    assert model_mod is td and sr_model.scale == 1
    # the grid doubled at step 2, the mask rebuilt at its resolution
    assert mcfg.num_voxels == 16 ** 3
    assert tuple(buffers["mask_cache"].shape) == mcfg.world_size
    last = tmp_path / "logs" / "chair" / "fine_last.npz"
    with np.load(str(last)) as z:
        assert int(z["opt/d/step"]) == 3
    served = run_sr.main(base + ["--render_only"])
    a, b = trained["test"], served["test"]
    assert np.isfinite(a["psnr_sr"]) and a["psnr_sr"] == b["psnr_sr"]
    for x, y in zip(a["sr_frames"], b["sr_frames"]):
        assert bool((x == y).all())
