"""Port parity of DirectMPIGO's training forms: the training forward with
a random background (the noise drawn once and given to both packages),
its gradients by torch autograd vs ``jax.grad``, progressive grid
scaling, the act_shift decay and the view-count mask.

Tolerances: forward values 1e-5 absolute; gradients within 1e-5 of the
largest entry of each leaf (relative to the leaf's scale: the density
gradient spans many decades); grids after scaling 1e-5; masks exact."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict as JConfigDict
from fourk_nerf_tpu.models import dmpigo as jd
from fourk_nerf_tpu.ops import rays as jrays
from fourk_nerf_tpu.train import losses as jl
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dmpigo as td
from fourk_nerf_torch.train import losses as tl

CFG_KW = dict(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
              num_voxels=16 * 16 * 8, mpi_depth=8, fast_color_thres=1.0 / 40,
              rgbnet_dim=6, rgbnet_width=16, viewbase_pe=2, spatial_pe=1)
TRAIN = JConfigDict(weight_main=1.0, weight_entropy_last=0.001,
                    weight_nearclip=0, weight_distortion=0.01,
                    weight_rgbper=0.01)


def _scene(seed=0, mask_frac=0.8, **cfg_kw):
    cfg_kw = {**CFG_KW, **cfg_kw}
    jcfg = jd.make_config(**cfg_kw)
    params, buffers = jd.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    params["density"] = rng.normal(-1, 2, params["density"].shape).astype(
        np.float32)
    params["k0"] = rng.normal(0, 1, params["k0"].shape).astype(np.float32)
    buffers = {"act_shift": np.asarray(buffers["act_shift"]),
               "mask_cache": rng.uniform(size=jcfg.mask_cache_world_size)
               < mask_frac}
    return jcfg, td.make_config(**cfg_kw), params, buffers


def _rays(H=6, W=8, dx=0.0):
    f = W * 0.75
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = (dx, 0.01, 1.0)
    return [np.array(a).reshape(-1, 3) for a in jrays.get_rays_of_a_view(
        H, W, K, c2w, ndc=True, inverse_y=False, flip_x=False, flip_y=False)]


def _assert_grads(tg, jg, path=""):
    if isinstance(jg, dict):
        for k in jg:
            _assert_grads(tg[k], jg[k], f"{path}/{k}")
        return
    jg = np.asarray(jg)
    scale = max(float(np.abs(jg).max()), 1e-30)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5 * scale,
                               err_msg=path)
    assert np.abs(jg).max() > 0, path


@pytest.mark.parametrize("ndc_planes", [True, False])
def test_training_forward_and_grads_match_jax(ndc_planes):
    jcfg, tcfg, params, buffers = _scene()
    ro, rd, vd = _rays()
    target = np.random.default_rng(1).uniform(size=(ro.shape[0], 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    # the JAX forward draws uniform(key, [N, 3]); the port takes that draw
    noise = np.array(jax.random.uniform(key, (ro.shape[0], 3)))

    def jloss(p):
        out = jd.forward(jcfg, p, jax.tree.map(jnp.asarray, buffers),
                         jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd),
                         stepsize=1.0, bg=0.0, rand_bkgd=True, is_train=True,
                         key=key, ndc_planes=ndc_planes)
        loss, _ = jl.encoder_losses(out, jnp.asarray(target), TRAIN,
                                    ro.shape[0])
        return loss, out["rgb_marched"]

    (jv, jrgb), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    leaves = [tp["density"], tp["k0"], *tp["rgbnet"].values()]
    for x in leaves:
        x.requires_grad_(True)
    out = td.forward(tcfg, tp, tb, *(torch.as_tensor(a) for a in (ro, rd, vd)),
                     stepsize=1.0, bg=0.0, rand_bkgd=True, is_train=True,
                     bg_noise=torch.as_tensor(noise), ndc_planes=ndc_planes)
    tv, _ = tl.encoder_losses(out, torch.as_tensor(target), TRAIN,
                              ro.shape[0])
    tv.backward()
    np.testing.assert_allclose(out["rgb_marched"].detach().numpy(),
                               np.asarray(jrgb), atol=1e-5)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    _assert_grads({k: (v.grad if k != "rgbnet" else
                       {n: w.grad for n, w in v.items()})
                   for k, v in tp.items()}, jg)


def test_rand_bkgd_needs_noise_and_eval_ignores_it():
    _, tcfg, params, buffers = _scene()
    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    ro, rd, vd = (torch.as_tensor(a) for a in _rays())
    kw = dict(stepsize=1.0, bg=0.25, ndc_planes=True)
    with pytest.raises(ValueError, match="bg_noise"):
        td.forward(tcfg, tp, tb, ro, rd, vd, rand_bkgd=True, is_train=True,
                   **kw)
    a = td.forward(tcfg, tp, tb, ro, rd, vd, **kw)
    b = td.forward(tcfg, tp, tb, ro, rd, vd, rand_bkgd=True,
                   bg_noise=torch.rand(ro.shape[0], 3), **kw)
    assert torch.equal(a["rgb_marched"], b["rgb_marched"])


@pytest.mark.parametrize("num_voxels", [40 * 40 * 8, 23 * 29 * 8])
def test_scale_volume_grid_matches_jax(num_voxels):
    jcfg, tcfg, params, buffers = _scene(seed=2, mask_frac=0.7)
    jc, jp, jb = jd.scale_volume_grid(jcfg, jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, buffers),
                                      num_voxels, 8)
    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    tc, tp2, tb2 = td.scale_volume_grid(tcfg, tp, tb, num_voxels, 8)
    for f in jc.__dataclass_fields__:
        assert getattr(tc, f) == getattr(jc, f), f
    for k in ("density", "k0"):
        assert tp2[k].is_contiguous()
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tb2["mask_cache"].numpy(),
                                  np.asarray(jb["mask_cache"]))
    assert tp2["rgbnet"] is tp["rgbnet"]
    decayed = td.decay_act_shift(tb2, 0.1)["act_shift"]
    np.testing.assert_allclose(
        decayed.numpy(), np.asarray(jd.decay_act_shift(jb, 0.1)["act_shift"]),
        atol=1e-7)


@pytest.mark.parametrize("cache", [None, (9, 13, 8)])
def test_update_occupancy_cache_lt_nviews_matches_jax(cache):
    jcfg, tcfg, _, _ = _scene(mask_cache_world_size=cache)
    # enough rays a voxel that some splat more than 1 and some do not
    views = [_rays(H=24, W=32, dx=dx) for dx in (-0.3, 0.0, 0.3)]
    jb = {"mask_cache": jnp.ones(jcfg.mask_cache_world_size, bool)}
    tb = {"mask_cache": torch.ones(tcfg.mask_cache_world_size,
                                   dtype=torch.bool)}
    want = np.asarray(jd.update_occupancy_cache_lt_nviews(
        jcfg, jb, [v[0] for v in views], [v[1] for v in views], 1.0, 2)
        ["mask_cache"])
    got = td.update_occupancy_cache_lt_nviews(
        tcfg, tb, [torch.as_tensor(v[0]) for v in views],
        [torch.as_tensor(v[1]) for v in views], 1.0, 2)["mask_cache"].numpy()
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


def test_get_kwargs_matches_jax_and_rebuilds_the_config():
    jcfg, tcfg, _, _ = _scene(mask_cache_world_size=(9, 13, 8))
    kw = td.get_kwargs(tcfg)
    assert kw == jd.get_kwargs(jcfg)
    assert td.make_config(**kw) == tcfg
