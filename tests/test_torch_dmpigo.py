"""Port parity: fourk_nerf_torch.models.dmpigo (+ grid_sample, common) vs
the JAX package on a small grid, params made with numpy and handed to both.
float32 paths agree to 1e-4."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import common as jcommon, dmpigo as jd
from fourk_nerf_tpu.ops import grid_sample as jgs, rays as jrays
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import common as tcommon, dmpigo as td
from fourk_nerf_torch.ops import grid_sample as tgs

TOL = 1e-4

CFG_KW = dict(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
              num_voxels=16 * 16 * 8, mpi_depth=8, fast_color_thres=1.0 / 40,
              rgbnet_dim=6, rgbnet_width=16, viewbase_pe=2, spatial_pe=1)


def _scene(seed=0, mask_frac=0.8, **cfg_kw):
    cfg_kw = {**CFG_KW, **cfg_kw}
    jcfg = jd.make_config(**cfg_kw)
    params, buffers = jd.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params["density"] = jnp.asarray(
        rng.normal(-1, 2, params["density"].shape).astype(np.float32))
    params["k0"] = jnp.asarray(
        rng.normal(0, 1, params["k0"].shape).astype(np.float32))
    buffers["mask_cache"] = jnp.asarray(
        rng.uniform(size=jcfg.mask_cache_world_size) < mask_frac)
    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    return jcfg, params, buffers, td.make_config(**cfg_kw), tp, tb


def test_make_config_matches_jax():
    for kw in (CFG_KW, dict(CFG_KW, mask_cache_world_size=(5, 6, 4),
                            act_type="gauss")):
        j, t = jd.make_config(**kw), td.make_config(**kw)
        assert dataclass_dict(j) == dataclass_dict(t)
        assert (j.k0_dim, j.dim0, j.n_samples(1.0)) == \
            (t.k0_dim, t.dim0, t.n_samples(1.0))


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_init_matches_jax_layout():
    jcfg = jd.make_config(**CFG_KW)
    jp, jb = jd.init(jcfg, jax.random.PRNGKey(0))
    tp, tb = td.init(td.make_config(**CFG_KW),
                     generator=torch.Generator().manual_seed(0), device="cpu")
    for k in ("density", "k0"):
        assert tuple(tp[k].shape) == jp[k].shape and float(tp[k].abs().sum()) == 0
    for k, v in jp["rgbnet"].items():
        assert tuple(tp["rgbnet"][k].shape) == v.shape
    np.testing.assert_allclose(tb["act_shift"].numpy(), np.asarray(jb["act_shift"]),
                               atol=1e-6)
    assert tb["mask_cache"].dtype == torch.bool and bool(tb["mask_cache"].all())
    np.testing.assert_allclose(tcommon.mpi_act_shift(256, 1.0),
                               jcommon.mpi_act_shift(256, 1.0))


def test_init_is_seeded():
    cfg = td.make_config(**CFG_KW)
    a, _ = td.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b, _ = td.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["rgbnet"]["w0"], b["rgbnet"]["w0"])


@pytest.mark.parametrize("ndc_planes", [True, False])
def test_forward_matches_jax(ndc_planes):
    jcfg, jp, jb, tcfg, tp, tb = _scene()
    H, W = 6, 8
    K = np.array([[6.0, 0, 4.0], [0, 6.0, 3.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    ro, rd, vd = (np.asarray(a).reshape(-1, 3) for a in jrays.get_rays_of_a_view(
        H, W, K, c2w, ndc=True, inverse_y=False, flip_x=False, flip_y=False))
    # jitted: one compile costs less on the CPU than eager op-by-op
    jout = jax.jit(functools.partial(
        jd.forward, jcfg, stepsize=1.0, bg=0.5, render_depth=True,
        ndc_planes=ndc_planes))(jp, jb, jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(vd))
    tout = td.forward(tcfg, tp, tb, torch.as_tensor(ro), torch.as_tensor(rd),
                      torch.as_tensor(vd), stepsize=1.0, bg=0.5,
                      render_depth=True, ndc_planes=ndc_planes)
    for k in ("rgb_marched", "rgb_feature", "alphainv_last", "depth",
              "weights", "raw_alpha"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=TOL, err_msg=k)
    assert float(tout["weights"].sum()) > 0.1  # the scene is not empty


def test_update_occupancy_cache_matches_jax():
    # a mask finer than the grid, and more than one x-slab of the query
    jcfg, jp, jb, tcfg, tp, tb = _scene(seed=1, mask_frac=0.9,
                                        mask_cache_world_size=(37, 11, 6))
    jm = np.asarray(jd.update_occupancy_cache(jcfg, jp, jb)["mask_cache"])
    tm = td.update_occupancy_cache(tcfg, tp, tb)["mask_cache"].numpy()
    assert tm.dtype == bool and tm.shape == jm.shape
    assert 0 < tm.sum() < tm.size
    np.testing.assert_array_equal(tm, jm)


def test_grid_ops_match_jax():
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(7, 6, 5, 3)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.trilinear_sample(torch.as_tensor(grid), torch.as_tensor(pts)).numpy(),
        np.asarray(jgs.trilinear_sample(jnp.asarray(grid), jnp.asarray(pts))),
        atol=1e-5)
    new = (11, 9, 13)
    np.testing.assert_allclose(
        tgs.resize_trilinear_chunked(torch.as_tensor(grid), new, z_chunk=4).numpy(),
        np.asarray(jgs.resize_trilinear_chunked(jnp.asarray(grid), new, z_chunk=4)),
        atol=1e-5)
    vol = rng.normal(size=(6, 7, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tgs.max_pool3d_same(torch.as_tensor(vol)).numpy(),
        np.asarray(jgs.max_pool3d_same(jnp.asarray(vol))))
    mask = rng.uniform(size=(6, 7, 5)) < 0.5
    lo, hi = np.array([-1, -1, -1], np.float32), np.array([1, 1, 1], np.float32)
    xyz = rng.uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tgs.nearest_mask_lookup(torch.as_tensor(mask), torch.as_tensor(xyz),
                                torch.as_tensor(lo), torch.as_tensor(hi)).numpy(),
        np.asarray(jgs.nearest_mask_lookup(jnp.asarray(mask), jnp.asarray(xyz),
                                           jnp.asarray(lo), jnp.asarray(hi))))


@pytest.mark.parametrize("act", ["relu", "lkrelu", "gauss"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(5)
    p = {f"w{i}": rng.normal(size=s).astype(np.float32) * 0.3
         for i, s in enumerate([(7, 16), (16, 16), (16, 3)])}
    p.update({f"b{i}": rng.normal(size=n).astype(np.float32) * 0.1
              for i, n in enumerate([16, 16, 3])})
    x = rng.normal(size=(9, 7)).astype(np.float32)
    j = jcommon.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jcommon.activation(act))
    t = tcommon.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                          torch.as_tensor(x), tcommon.activation(act))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
