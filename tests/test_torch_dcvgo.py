"""Port parity of DirectContractedVoxGO (``models/dcvgo.py``) against the
JAX package's, float32 on the CPU, on a 24^3 grid over the contracted cube
with numpy-drawn params and the rays of 32x32 views from the Blender
sphere (cameras at radius 4 inside a foreground cube of half-side 4.5, as
the NeRF++ loader's near-clip rule puts them).

The shared lattice ``t`` is computed as XLA computes the JAX package's
``linspace`` and is equal. The sample points need not be: XLA fuses
``o + d t``, the direction's norm and the contraction with fused
multiply-adds as its fusion decides (the JAX package's own eager and
jitted ``sample_ray`` points differ in ~36% of their entries), so the
points are held to 1e-6, and the distance between two crowded outer
samples, a difference of nearly equal numbers, can flip the spacing
filter's ``cum > thres``. The share of keep-mask entries that differ from
the jitted JAX forward's own on real rays is reported (measured 0 at steps
0.5 and 1; held under 1%). So the forward and its gradients are held in
two ways: with the port's keep mask replaced by the JAX forward's
(recovered from its ``raw_alpha``), every output within 1e-5 (the masked
density 1e-4: point differences of a few ulps times the slope of a noise
grid) and the gradients within 1e-5 of each leaf's largest entry; and as
they are, the colour within 0.02 and the loss 1e-2 relative, what a flip
of a few outer samples may move (measured 5e-7 and 1e-7: none flipped).
``cumdist_keep_mask`` itself is exact on the same gaps; the configs equal;
the scaled grids 2e-5, its mask and the occupancy renewal's equal; the TV
gradients 1e-7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict
from fourk_nerf_tpu.models import dcvgo as jd
from fourk_nerf_tpu.ops import rays as jrays
from fourk_nerf_tpu.train import losses as jl
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import common, dcvgo as td
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import losses as tl

FG = dict(xyz_min=[-4.4, -4.6, -4.3], xyz_max=[4.6, 4.4, 4.7])
NEAR_THRES = 0.05
TRAIN = ConfigDict(dict(weight_main=1.0, weight_entropy_last=0.01,
                        weight_nearclip=0.5, weight_distortion=0.01,
                        weight_rgbper=0.01))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, norm="inf", **kw):
    return mod.make_config(num_voxels=24 ** 3, num_voxels_base=24 ** 3,
                           alpha_init=1e-2, fast_color_thres=1e-4,
                           rgbnet_dim=6, rgbnet_width=16,
                           contracted_norm=norm, **{**FG, **kw})


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    X, Y, Z = cfg.world_size
    dims = [3 + 3 * 4 * 2 + 6, 16, 16, 3]
    rgbnet = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        rgbnet[f"w{i}"] = (rng.normal(0, 1, (a, b)) / np.sqrt(a)).astype(
            np.float32)
        rgbnet[f"b{i}"] = rng.normal(0, 0.1, b).astype(np.float32)
    params = {
        "density": rng.normal(-1.0, 2.0, (X, Y, Z, 1)).astype(np.float32),
        "k0": rng.normal(0, 1, (X, Y, Z, 6)).astype(np.float32),
        "rgbnet": rgbnet}
    return params, {"mask_cache": rng.uniform(size=(X, Y, Z)) < 0.9}


def _rays(view=1, hw=32):
    c2w = tiny_scene.bounded_poses(4)[view]
    f = tiny_scene.blender_focal(hw)
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32)
    rays = jrays.get_rays_of_a_view(hw, hw, K, c2w, ndc=False,
                                    inverse_y=False, flip_x=False,
                                    flip_y=False)
    return tuple(np.asarray(x).reshape(-1, 3) for x in rays)


def _jax_forward(cfg, params, buffers, rays, stepsize, **kw):
    fwd = jax.jit(lambda p, b, ro, rd, vd: jd.forward(
        cfg, p, b, ro, rd, vd, stepsize=stepsize, render_depth=True, **kw))
    out = fwd(jax.tree.map(jnp.asarray, params),
              jax.tree.map(jnp.asarray, buffers),
              *(jnp.asarray(a) for a in rays))
    return {k: v if k == "n_max" else np.asarray(v) for k, v in out.items()}


def _jax_valid(cfg, rays, stepsize):
    """The JAX forward's own sample mask before the occupancy and alpha
    tests: ``raw_alpha != 0`` with a full mask and no alpha threshold
    (every sample's alpha is positive at these densities)."""
    free = jd.Config(**{**cfg.__dict__, "fast_color_thres": 0.0})
    params, buffers = _params(cfg)
    buffers = {"mask_cache": np.ones(cfg.mask_cache_world_size, bool)}
    return _jax_forward(free, params, buffers, rays, stepsize)[
        "raw_alpha"] != 0


def test_config_matches_jax_and_round_trips():
    for norm in ("inf", "l2"):
        j, t = _cfg(jd, norm), _cfg(td, norm)
        assert {f: getattr(t, f) for f in j.__dataclass_fields__} == \
            j.__dict__
        assert (t.xyz_min, t.xyz_max, t.voxel_size_ratio, t.act_shift) == \
            (j.xyz_min, j.xyz_max, j.voxel_size_ratio, j.act_shift)
        assert t.n_samples(0.5) == j.n_samples(0.5) and t.dim0 == 33
        kw = td.get_kwargs(t)
        assert kw == jd.get_kwargs(j)
        # the file's cube gives the centre and radius back to float64
        # rounding, in both packages alike
        back = td.make_config(**kw)
        assert {f: getattr(back, f) for f in j.__dataclass_fields__} == \
            jd.make_config(**kw).__dict__
        assert back.world_size == t.world_size
        np.testing.assert_allclose(back.scene_center + back.scene_radius,
                                   t.scene_center + t.scene_radius,
                                   rtol=0, atol=1e-12)
    # the published width: 160^3 voxels give a 159^3 grid and 532 samples
    full = td.make_config(num_voxels=160 ** 3, num_voxels_base=160 ** 3,
                          alpha_init=1e-2, **FG)
    assert full.world_size == (159,) * 3 and full.n_samples(0.5) == 532


@pytest.mark.parametrize("norm", ["inf", "l2"])
@pytest.mark.parametrize("stepsize", [0.5, 1.0])
def test_sample_ray_matches_jax(norm, stepsize):
    jc, tc = _cfg(jd, norm), _cfg(td, norm)
    ro, rd, _ = _rays()
    jp, ji, jt = jax.jit(lambda a, b: jd.sample_ray(
        jc, a, b, stepsize=stepsize))(jnp.asarray(ro), jnp.asarray(rd))
    tp, ti, tt = td.sample_ray(tc, torch.as_tensor(ro), torch.as_tensor(rd),
                               stepsize=stepsize)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert 0 < ti.float().mean() < 1
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert np.abs(tp.numpy()).max() <= 1 + tc.bg_len + 1e-6


def test_cumdist_keep_mask_exact_on_random_gaps():
    rng = np.random.default_rng(1)
    # gaps from crowded to wide, as along a contracted ray
    dist = (rng.uniform(0, 1, (64, 200)) * np.logspace(-1, -4, 200)).astype(
        np.float32)
    for thres in (0.01, 0.0237, 0.1):
        want = np.asarray(jax.jit(lambda d: jd.cumdist_keep_mask(d, thres))(
            jnp.asarray(dist)))
        got = td.cumdist_keep_mask(torch.as_tensor(dist), thres).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1


@pytest.mark.parametrize("stepsize", [0.5, 1.0])
def test_keep_mask_share_that_differs_on_real_rays(stepsize):
    jc, tc = _cfg(jd), _cfg(td)
    rays = _rays()
    want = _jax_valid(jc, rays, stepsize)
    tp, ti, _ = td.sample_ray(tc, torch.as_tensor(rays[0]),
                              torch.as_tensor(rays[1]), stepsize=stepsize)
    got = td.keep_mask(tc, tp, ti, stepsize).numpy()
    share = float(np.mean(got != want))
    print(f"keep-mask entries that differ at step {stepsize}: {share:.4f}")
    assert share < 0.01
    assert 0.2 < want.mean() < 0.9  # the filter drops outer samples


def _port_forward(tc, params, buffers, rays, stepsize, keep=None, **kw):
    p, b = weights.dcvgo_from_numpy(params, buffers, "cpu")
    return td.forward(tc, p, b, *(torch.as_tensor(a) for a in rays),
                      stepsize=stepsize, render_depth=True, **kw)


@pytest.mark.parametrize("form", ["eval", "train"])
def test_forward_matches_jax(form, monkeypatch):
    stepsize = 0.5
    jc, tc = _cfg(jd), _cfg(td)
    params, buffers = _params(jc)
    rays = _rays()
    kw = dict(bg=1.0)
    noise = np.random.default_rng(3).uniform(0, 1, (rays[0].shape[0], 3))
    if form == "train":  # the JAX form draws its noise; the port takes it
        kw = dict(bg=0.0, rand_bkgd=True, is_train=True)
    want = _jax_forward(jc, params, buffers, rays, stepsize,
                        **(kw if form == "eval" else dict(bg=0.0)))
    if form == "train":
        want["rgb_marched"] = want["rgb_marched"] + \
            want["alphainv_last"][:, None] * noise.astype(np.float32)
        want["rgb_feature"] = want["rgb_marched"]
        kw["bg_noise"] = torch.as_tensor(noise, dtype=torch.float32)
    own = _port_forward(tc, params, buffers, rays, stepsize, **kw)
    np.testing.assert_allclose(own["rgb_marched"].numpy(),
                               want["rgb_marched"], rtol=0, atol=0.02)
    valid = torch.as_tensor(_jax_valid(jc, rays, stepsize))
    monkeypatch.setattr(td, "keep_mask", lambda *a: valid)
    got = _port_forward(tc, params, buffers, rays, stepsize, **kw)
    assert got["n_max"] == want["n_max"] == tc.n_samples(stepsize)
    assert set(got) == set(want)
    for k in want:
        if k != "n_max":
            np.testing.assert_allclose(
                got[k].numpy(), want[k], rtol=0,
                atol=1e-4 if k == "raw_density" else 1e-5, err_msg=k)
    assert 0.05 < float(want["wsum_mid"].mean()) < 0.95
    if form == "eval":
        assert got["rgb_feature"] is got["rgb_marched"]


def _jax_loss_grads(jc, params, buffers, rays, target, stepsize):
    def loss_fn(p):
        out = jd.forward(jc, p, buffers, *rays, stepsize=stepsize, bg=1.0)
        return jl.encoder_losses(out, target, TRAIN, rays[0].shape[0],
                                 near_thres=NEAR_THRES)

    (loss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return (float(loss), {k: float(v) for k, v in terms.items()},
            jax.tree.map(np.asarray, grads))


def _port_loss_grads(tc, params, buffers, rays, target, stepsize):
    p, b = weights.dcvgo_from_numpy(params, buffers, "cpu")
    leaves = {"density": p["density"], "k0": p["k0"], **{
        f"rgbnet/{k}": v for k, v in p["rgbnet"].items()}}
    for v in leaves.values():
        v.requires_grad_(True)
    out = td.forward(tc, p, b, *(torch.as_tensor(a) for a in rays),
                     stepsize=stepsize, bg=1.0)
    loss, terms = tl.encoder_losses(out, torch.as_tensor(target), TRAIN,
                                    rays[0].shape[0], near_thres=NEAR_THRES)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.item(), {k: v.item() for k, v in terms.items()},
            dict(zip(leaves, grads)))


def test_loss_gradients_match_jax(monkeypatch):
    """The training loss with the near-clip and distortion terms (the
    near threshold cuts into the first samples of the rays from the
    cameras) and its gradients."""
    stepsize = 0.5
    jc, tc = _cfg(jd), _cfg(td)
    params, buffers = _params(jc, seed=4)
    params["density"] += 3.0  # the first samples pass the alpha threshold
    rays = _rays(view=2)
    target = np.random.default_rng(5).uniform(
        0, 1, (rays[0].shape[0], 3)).astype(np.float32)
    loss_j, terms_j, grads_j = _jax_loss_grads(
        jc, params, jax.tree.map(jnp.asarray, buffers),
        tuple(jnp.asarray(a) for a in rays), jnp.asarray(target), stepsize)
    assert {"nearclip", "distortion", "rgbper", "entropy_last"} <= set(terms_j)
    loss_o, _, _ = _port_loss_grads(tc, params, buffers, rays, target,
                                    stepsize)
    np.testing.assert_allclose(loss_o, loss_j, rtol=1e-2)
    valid = torch.as_tensor(_jax_valid(jc, rays, stepsize))
    monkeypatch.setattr(td, "keep_mask", lambda *a: valid)
    loss_t, terms_t, grads_t = _port_loss_grads(tc, params, buffers, rays,
                                                target, stepsize)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert set(terms_t) == set(terms_j)
    for k, v in terms_j.items():
        np.testing.assert_allclose(terms_t[k], v, rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    want = {"density": grads_j["density"], "k0": grads_j["k0"], **{
        f"rgbnet/{k}": v for k, v in grads_j["rgbnet"].items()}}
    # the near-clip term reaches the density (its value is 0)
    assert terms_j["nearclip"] == 0.0
    for k, w in want.items():
        ref = np.abs(w).max()
        assert ref > 0, k
        np.testing.assert_allclose(grads_t[k].numpy(), w, rtol=0,
                                   atol=1e-5 * ref, err_msg=k)


def test_nearclip_gradient_reaches_the_density_near_the_cameras():
    """Without the near-clip weight, the density gradient of the samples
    nearer than the threshold is that of the other terms only."""
    stepsize = 0.5
    tc = _cfg(td)
    params, buffers = _params(tc, seed=4)
    params["density"] += 4.0  # the first samples pass the alpha threshold
    buffers["mask_cache"][:] = True
    rays = _rays(view=2)
    target = np.zeros((rays[0].shape[0], 3), np.float32)
    grads = []
    for w in (0.0, 0.5):
        TRAIN.weight_nearclip = w
        try:
            grads.append(_port_loss_grads(tc, params, buffers, rays, target,
                                          stepsize)[2]["density"])
        finally:
            TRAIN.weight_nearclip = 0.5
    assert not torch.equal(grads[0], grads[1])


def test_scale_volume_grid_and_occupancy_match_jax():
    jc, tc = _cfg(jd), _cfg(td)
    params, buffers = _params(jc, seed=6)
    params["density"] -= 6.0  # voxels whose dilated alpha falls under 1e-4
    jb = jax.tree.map(jnp.asarray, buffers)
    jp = jax.tree.map(jnp.asarray, params)
    p, b = weights.dcvgo_from_numpy(params, buffers, "cpu")
    jcfg2, jp2, jb2 = jd.scale_volume_grid(jc, jp, jb, 28 ** 3)
    tcfg2, tp2, tb2 = td.scale_volume_grid(tc, p, b, 28 ** 3)
    assert {f: getattr(tcfg2, f) for f in jcfg2.__dataclass_fields__} == \
        jcfg2.__dict__
    for k in ("density", "k0"):
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   rtol=0, atol=2e-5, err_msg=k)
    # the mask rebuilt at the new resolution
    np.testing.assert_array_equal(tb2["mask_cache"].numpy(),
                                  np.asarray(jb2["mask_cache"]))
    assert tuple(tb2["mask_cache"].shape) == tcfg2.world_size != tc.world_size
    assert 0 < int(tb2["mask_cache"].sum()) < tb2["mask_cache"].numel()
    want = jd.update_occupancy_cache(jc, jp, jb)["mask_cache"]
    got = td.update_occupancy_cache(tc, p, b)["mask_cache"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) < int(b["mask_cache"].sum())


@pytest.mark.parametrize("dense", [True, False])
def test_tv_grads_match_jax(dense):
    jc, tc = _cfg(jd), _cfg(td)
    params, _ = _params(jc, seed=7)
    rng = np.random.default_rng(8)
    sparse = {k: np.where(rng.uniform(size=params[k].shape) < 0.5, 1.0,
                          0.0).astype(np.float32) for k in ("density", "k0")}
    jp = jax.tree.map(jnp.asarray, params)
    p, _ = weights.dcvgo_from_numpy(params, {}, "cpu")
    for name, jf in (("density", jd.density_tv_grad),
                     ("k0", jd.k0_tv_grad)):
        want = jf(jc, jp, 0.1, dense, 256, jnp.asarray(sparse[name]))
        got = common.grid_tv_grad(
            getattr(tc, f"{name}_type"), p[name],
            *td.tv_weights(tc, 0.1, 256),
            None if dense else torch.as_tensor(sparse[name]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7, err_msg=name)


def test_init_and_tensorf_grids():
    tc = _cfg(td)
    p, b = td.init(tc, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    assert tuple(p["density"].shape) == (*tc.world_size, 1)
    assert tuple(p["k0"].shape) == (*tc.world_size, 6)
    assert p["rgbnet"]["w0"].shape == (33, 16) and bool(b["mask_cache"].all())
    # TensoRF grids: factors drawn, and the forward runs on them (their
    # parity with the JAX package: tests/test_torch_tensorf.py)
    tens = td.make_config(num_voxels=24 ** 3, num_voxels_base=24 ** 3,
                          alpha_init=1e-2, density_type="TensoRFGrid",
                          density_config={"n_comp": 4}, **FG)
    tp, tb = td.init(tens, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    X, Y, Z = tens.world_size
    assert tuple(tp["density"]["xy_plane"].shape) == (X, Y, 4)
    assert "f_vec" not in tp["density"]
    assert tuple(tp["k0"].shape) == (X, Y, Z, 3)
    ro = torch.zeros((5, 3))
    rd = torch.nn.functional.normalize(torch.randn(
        (5, 3), generator=torch.Generator().manual_seed(1)), dim=-1)
    out = td.forward(tens, tp, tb, ro, rd, rd, stepsize=1.0)
    assert bool(torch.isfinite(out["rgb_marched"]).all())
