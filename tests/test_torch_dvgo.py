"""Port parity: fourk_nerf_torch.models.dvgo (eval side) and the bounded-
scene helpers it rests on vs the JAX package, on the scene of
tests/test_box_sweep.py. float32 on the CPU; tolerances stated per test."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import common as jcommon, dvgo as jd
from fourk_nerf_tpu.ops import rays as jrays, render as jrender
from fourk_nerf_tpu.utils import metrics as jmetrics
from fourk_nerf_torch.models import common as tcommon, dvgo as td
from fourk_nerf_torch.ops import render as trender
from fourk_nerf_torch.utils import metrics as tmetrics
from test_box_sweep import _camera, _scene
from test_torch_box import direct_scene, port_scene

TOL = 2e-5  # float32 sums in another order


def _rays(H, W, K, c2w):
    out = jrays.get_rays_of_a_view(H, W, K, c2w, ndc=False, inverse_y=False,
                                   flip_x=False, flip_y=False)
    return [np.array(a).reshape(-1, 3) for a in out]


@pytest.mark.parametrize("mode,mask_res", [
    ("none", None), ("residual", None), ("direct", None),
    ("residual", (12, 10, 8))])
def test_dvgo_forward_matches_jax(mode, mask_res):
    rng = np.random.default_rng(3)
    cfg, params, buffers = _scene(rng, rgbnet_dim=0 if mode == "none" else 6,
                                  mask_res=mask_res)
    if mode == "direct":
        cfg, params, buffers = direct_scene(cfg, params, buffers, rng)
    H, W = 12, 16
    K, c2w = _camera(H, W)
    ro, rd, vd = _rays(H, W, K, c2w)
    kw = dict(stepsize=0.5, near=0.2, far=1e9, bg=0.7, render_depth=True)
    ref = jax.jit(lambda p, b, o, d, v: jd.forward(cfg, p, b, o, d, v, **kw))(
        params, buffers, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd))
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    got = td.forward(tcfg, tp, tb, *(torch.as_tensor(a) for a in (ro, rd, vd)),
                     **kw)
    assert float(np.abs(np.asarray(ref["rgb_marched"]) - 0.7).max()) > 0.05
    for k in ("rgb_marched", "rgb_feature", "depth", "alphainv_last",
              "weights", "raw_alpha", "s"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=TOL, err_msg=k)
    # the port colours only the weighted samples (fast_color_thres > 0):
    # raw_rgb is JAX's there and 0 at the others, which no output reads
    on = got["weights"].numpy() > 0
    assert tcfg.fast_color_thres > 0 and 0 < on.sum() < on.size
    rgb = got["raw_rgb"].numpy()
    np.testing.assert_allclose(rgb[on], np.asarray(ref["raw_rgb"])[on],
                               atol=TOL)
    assert not rgb[~on].any()
    assert got["n_max"] == ref["n_max"]


def test_dvgo_config_matches_jax():
    kw = dict(xyz_min=[-1.0, -0.8, -0.6], xyz_max=[1.0, 0.9, 0.7],
              num_voxels=24 * 20 * 16, num_voxels_base=30 ** 3,
              alpha_init=1e-2, rgbnet_dim=12, rgbnet_direct=True,
              fast_color_thres=1e-4, mask_cache_world_size=(12, 10, 8),
              k0_config={"a": 1})
    j, t = jd.make_config(**kw), td.make_config(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("voxel_size_ratio", "k0_dim", "dim0", "act_shift"):
        assert getattr(j, prop) == getattr(t, prop), prop
    for resid in (dataclasses.replace(t, rgbnet_direct=False),
                  dataclasses.replace(t, rgbnet_dim=0)):
        jr = jd.Config(**dataclasses.asdict(resid))
        assert (resid.k0_dim, resid.dim0) == (jr.k0_dim, jr.dim0)
    assert t.dim0 == 12 + 27
    assert j.n_samples(0.5) == t.n_samples(0.5)
    assert j.n_samples_ref(0.5) == t.n_samples_ref(0.5)
    assert jd.get_kwargs(j) == td.get_kwargs(t)
    assert jcommon.dvgo_grid_resolution([-1, -2, -3], [1.5, 2, 3], 10 ** 6) \
        == tcommon.dvgo_grid_resolution([-1, -2, -3], [1.5, 2, 3], 10 ** 6)


def test_dvgo_init_shapes_and_device():
    cfg = td.make_config([-1, -1, -1], [1, 1, 1], 12 ** 3, 12 ** 3, 1e-2,
                         rgbnet_dim=6, rgbnet_width=16)
    p, b = td.init(cfg, generator=torch.Generator().manual_seed(1),
                   device="cpu")
    assert p["density"].shape == (*cfg.world_size, 1)
    assert p["k0"].shape == (*cfg.world_size, 6)
    assert p["rgbnet"]["w0"].shape == (cfg.dim0, 16)
    assert b["mask_cache"].dtype == torch.bool and bool(b["mask_cache"].all())
    p2, _ = td.init(cfg, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    assert torch.equal(p["rgbnet"]["w1"], p2["rgbnet"]["w1"])
    # the default device is the card: without one the entry point raises
    with pytest.raises(RuntimeError):
        td.init(cfg)


def test_ray_aabb_and_fixed_sampling_match_jax():
    rng = np.random.default_rng(0)
    ro = rng.normal(0, 2.0, (64, 3)).astype(np.float32)
    rd = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    rd[:8, 0] = 0.0  # axis-parallel components take the 1e-6 guard
    mn = np.array([-1.0, -0.8, -0.6], np.float32)
    mx = np.array([1.0, 0.9, 0.7], np.float32)
    j = jrender.ray_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(mn),
                         jnp.asarray(mx), 0.2, 1e9)
    t = trender.ray_aabb(*(torch.as_tensor(a) for a in (ro, rd, mn, mx)),
                         0.2, 1e9)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    jp, jv, jt = jrender.sample_pts_on_rays_fixed(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(mn), jnp.asarray(mx),
        0.2, 7.0, 0.05, 40)
    tp, tv, tt = trender.sample_pts_on_rays_fixed(
        *(torch.as_tensor(a) for a in (ro, rd, mn, mx)), 0.2, 7.0, 0.05, 40)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    # validity may flip only for a point that sits on a box face
    assert float((tv.numpy() != np.asarray(jv)).mean()) < 2e-3
    assert tv.any() and not tv.all()


def test_hit_coarse_geo_and_occupancy_match_jax():
    rng = np.random.default_rng(7)
    for mask_res in (None, (12, 10, 8)):
        cfg, params, buffers = _scene(rng, mask_res=mask_res)
        tcfg, tp, tb = port_scene(cfg, params, buffers)
        H, W = 10, 12
        K, c2w = _camera(H, W)
        ro, rd, _ = _rays(H, W, K, c2w)
        kw = dict(near=0.2, far=1e9, stepsize=0.5)
        jh = jd.hit_coarse_geo(cfg, buffers, jnp.asarray(ro), jnp.asarray(rd),
                               **kw)
        th = td.hit_coarse_geo(tcfg, tb, torch.as_tensor(ro),
                               torch.as_tensor(rd), **kw)
        assert np.array_equal(th.numpy(), np.asarray(jh))
        jb = jax.jit(lambda p, b: jd.update_occupancy_cache(cfg, p, b))(
            params, buffers)
        tb2 = td.update_occupancy_cache(tcfg, tp, tb)
        jm, tm = np.asarray(jb["mask_cache"]), tb2["mask_cache"].numpy()
        # alpha against the threshold: a voxel may flip on float rounding
        assert tm.shape == jm.shape and float((tm != jm).mean()) < 1e-3
        assert 0 < tm.sum() < tm.size


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(24, 30, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert tmetrics.psnr(a, b) == pytest.approx(jmetrics.psnr(a, b), abs=1e-9)
    assert tmetrics.mse2psnr(0.01) == pytest.approx(20.0)
    assert tmetrics.rgb_ssim(a, b) == pytest.approx(jmetrics.rgb_ssim(a, b),
                                                    abs=1e-12)
    np.testing.assert_array_equal(tmetrics.to8b(a * 1.2 - 0.1),
                                  jmetrics.to8b(a * 1.2 - 0.1))
    m = tmetrics.rgb_ssim(a, b, return_map=True)
    assert m.shape == (14, 20, 3)
    with pytest.raises(ValueError):
        tmetrics.rgb_ssim(a, b[:-1])
