"""Port parity of DirectVoxGO's training forms (``models/dvgo.py``), the
coarse checkpoint's mask (``train/checkpoints.py``) and the box of the
coarse geometry (``train/trainer.py``) against the JAX package, on 12^3 to
16^3 grids, float32 on the CPU.

Tolerances: the training loss 1e-5 relative and its gradients within
1e-5 of each leaf's largest entry (float32 sums in another order); the
TV gradients 1e-7 absolute (the same slices and clips); the near-camera
mask-out, the masks of the scaled grid, of ``init`` and of the coarse
checkpoints, and the box equal; the scaled grids 2e-5 (float32 interpolation of entries up to
~8, in another order); the view counts
equal (integer counts of sums above 1)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict
from fourk_nerf_tpu.models import dvgo as jd
from fourk_nerf_tpu.ops import rays as jrays
from fourk_nerf_tpu.train import checkpoints as jc, losses as jl, \
    trainer as jt
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import common, dvgo as td
from fourk_nerf_torch.train import checkpoints as tc, \
    trainer as tt

WORLD = (16, 14, 12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=0, rgbnet_dim=6, world=WORLD, alpha_init=1e-2):
    rng = np.random.default_rng(seed)
    cfg = jd.make_config(
        xyz_min=[-1.0, -0.8, -0.6], xyz_max=[1.0, 0.9, 0.7],
        num_voxels=int(np.prod(world)), num_voxels_base=int(np.prod(world)),
        alpha_init=alpha_init, rgbnet_dim=rgbnet_dim, rgbnet_width=16,
        rgbnet_depth=3, fast_color_thres=1e-4)
    params, buffers = jd.init(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    dens = rng.normal(-1.0, 2.0, params["density"].shape).astype(np.float32)
    # an empty one-voxel margin, as a trained scene's box has: a ray's
    # first and last samples lie on the box's faces, where the in-box test
    # is a knife-edge that float32 rounding resolves either way
    dens[[0, -1]] = -8.0
    dens[:, [0, -1]] = -8.0
    dens[:, :, [0, -1]] = -8.0
    params["density"] = dens
    params["k0"] = rng.normal(0.0, 1.0, params["k0"].shape).astype(np.float32)
    for k, v in params.get("rgbnet", {}).items():
        params["rgbnet"][k] = rng.normal(
            0, 0.1 if k[0] == "b" else 1.0 / np.sqrt(v.shape[0]),
            v.shape).astype(np.float32)
    buffers = {"mask_cache": rng.uniform(size=cfg.world_size) > 0.3}
    return cfg, params, buffers


def _port(cfg, params, buffers):
    tcfg = td.make_config(**jd.get_kwargs(cfg))
    return (tcfg,) + weights.dvgo_from_numpy(params, buffers, device="cpu")


def _views(n=3, hw=(10, 12), dist=2.5):
    """Rays ``[H, W, 3]`` of ``n`` cameras looking at the origin."""
    H, W = hw
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out = []
    for i in range(n):
        ax, ay = 0.3 + 0.2 * i, 0.7 * i
        Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                       [0, np.sin(ax), np.cos(ax)]])
        Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                       [-np.sin(ay), 0, np.cos(ay)]])
        c2w = np.eye(4, dtype=np.float32)[:3, :4]
        c2w[:3, :3] = Ry @ Rx
        c2w[:3, 3] = (Ry @ Rx) @ np.array([0, 0, dist])
        out.append([np.asarray(a) for a in jrays.get_rays_of_a_view(
            H, W, K, c2w, ndc=False, inverse_y=False, flip_x=False,
            flip_y=False)] + [c2w])
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    v = tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return {prefix[:-1]: v}


CFG_TRAIN = ConfigDict(dict(weight_main=1.0, weight_entropy_last=0.01,
                            weight_nearclip=0, weight_distortion=0.01,
                            weight_rgbper=0.1, weight_tv_density=0.0,
                            weight_tv_k0=0.0))


def _blob_scene(rgbnet_dim):
    """:func:`_scene` with the density of a trained bounded scene: an
    opaque ball of radius 0.45 around the centre, empty space around it,
    so that few of a ray's samples carry weight."""
    cfg, params, buffers = _scene(rgbnet_dim=rgbnet_dim)
    rng = np.random.default_rng(5)
    xyz = np.stack(np.meshgrid(*[np.linspace(cfg.xyz_min[d], cfg.xyz_max[d],
                                             cfg.world_size[d])
                                 for d in range(3)], indexing="ij"), -1)
    ball = (xyz ** 2).sum(-1) < 0.45 ** 2
    dens = np.where(ball, rng.normal(6.0, 2.0, ball.shape),
                    rng.normal(-8.0, 0.5, ball.shape))
    params["density"] = dens[..., None].astype(np.float32)
    return cfg, params, buffers


def _check_loss_and_grads(cfg, params, buffers, ro, rd, vd):
    """The port's training loss, its terms and every gradient against the
    JAX step's on the rays ``ro, rd, vd``; returns the port's weights."""
    target = np.random.default_rng(1).uniform(0, 1, ro.shape).astype(
        np.float32)
    kw = dict(stepsize=0.5, near=0.2, far=6.0, bg=1.0)
    n = ro.shape[0]

    def jloss(p):
        out = jd.forward(cfg, p, jax.tree.map(jnp.asarray, buffers),
                         jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd),
                         is_train=True, rand_bkgd=True, **kw)
        return jl.encoder_losses(out, jnp.asarray(target), CFG_TRAIN, n)

    (lj, tj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tcfg, tp, tb = _port(cfg, params, buffers)
    step = tt.TrainStep(td, tcfg, CFG_TRAIN,
                        render_kwargs=dict(kw, rand_bkgd=True))
    batch = tuple(torch.as_tensor(a) for a in (ro, rd, vd, target))
    lt, tt_terms, gt = step.loss_and_grads(tp, tb, batch, list(params))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert set(tt_terms) == set(tj)
    for k, v in tj.items():
        np.testing.assert_allclose(float(tt_terms[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    want, got = _flat(gj), _flat(gt)
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    return td.forward(tcfg, tp, tb, *batch[:3], **kw)["weights"]


@pytest.mark.parametrize("rgbnet_dim", [0, 6])
def test_training_loss_and_grads_match_jax(rgbnet_dim):
    cfg, params, buffers = _scene(rgbnet_dim=rgbnet_dim)
    ro, rd, vd, _ = _views(1)[0]
    ro, rd, vd = (a.reshape(-1, 3)[::2] for a in (ro, rd, vd))
    _check_loss_and_grads(cfg, params, buffers, ro, rd, vd)


@pytest.mark.parametrize("rgbnet_dim", [0, 6])
def test_training_on_few_weighted_samples_matches_jax(rgbnet_dim):
    """The port colours only the weighted samples, the JAX step all of
    them: on a scene where under 5% of the samples carry weight (as in a
    trained scene's fine stage) the loss and the gradients still agree."""
    cfg, params, buffers = _blob_scene(rgbnet_dim)
    ro, rd, vd, _ = _views(1)[0]
    ro, rd, vd = (a.reshape(-1, 3) for a in (ro, rd, vd))
    w = _check_loss_and_grads(cfg, params, buffers, ro, rd, vd)
    share = float((w > 0).float().mean())
    assert 0.005 < share < 0.05, share


def test_depth_carries_no_gradient():
    cfg, params, buffers = _scene()
    tcfg, tp, tb = _port(cfg, params, buffers)
    ro, rd, vd, _ = _views(1)[0]
    tp["density"].requires_grad_(True)
    out = td.forward(tcfg, tp, tb, *(torch.as_tensor(a.reshape(-1, 3))
                                     for a in (ro, rd, vd)),
                     stepsize=0.5, near=0.2, far=6.0, render_depth=True)
    assert not out["depth"].requires_grad
    assert out["rgb_marched"].requires_grad


def test_maskout_near_cam_vox_matches_jax(monkeypatch):
    cfg, params, buffers = _scene()
    rng = np.random.default_rng(4)
    cams = rng.uniform(-1.2, 1.2, (70, 3)).astype(np.float32)
    want = jd.maskout_near_cam_vox(cfg, jax.tree.map(jnp.asarray, params),
                                   cams, 0.35)
    tcfg, tp, _ = _port(cfg, params, buffers)
    # small chunks: the running minimum crosses slabs and camera chunks
    monkeypatch.setattr(td, "_OCC_X_CHUNK", 5)
    monkeypatch.setattr(td, "_CAM_CHUNK", 16)
    got = td.maskout_near_cam_vox(tcfg, tp, cams, 0.35)
    d = np.asarray(want["density"])
    assert 0 < int((d == -100.0).sum()) < d.size
    np.testing.assert_array_equal(got["density"].numpy(), d)
    assert torch.equal(tp["density"], torch.as_tensor(params["density"]))


@pytest.mark.parametrize("num_voxels", [20 ** 3, 9 ** 3])
def test_scale_volume_grid_matches_jax(num_voxels):
    cfg, params, buffers = _scene()
    jcfg, jp, jb = jd.scale_volume_grid(
        cfg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, buffers), num_voxels)
    tcfg, tp, tb = _port(cfg, params, buffers)
    gcfg, gp, gb = td.scale_volume_grid(tcfg, tp, tb, num_voxels)
    assert td.get_kwargs(gcfg) == jd.get_kwargs(jcfg)
    assert gcfg.world_size == jcfg.world_size != cfg.world_size
    for k in ("density", "k0"):
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(jp[k]),
                                   atol=2e-5, rtol=0, err_msg=k)
    m = np.asarray(jb["mask_cache"])
    assert m.shape == jcfg.world_size and 0 < m.sum() < m.size
    np.testing.assert_array_equal(gb["mask_cache"].numpy(), m)


def test_scale_volume_grid_keeps_a_large_mask(monkeypatch):
    """Above 256^3 voxels the mask keeps its resolution (the scaled grid
    is never formed here: the rule is read off a 12^3 grid scaled to
    300^3 with the resize stubbed)."""
    cfg, params, buffers = _scene(world=(12, 12, 12))
    tcfg, tp, tb = _port(cfg, params, buffers)
    monkeypatch.setattr(td.grid_sample, "resize_trilinear_chunked",
                        lambda g, size: g)
    gcfg, _, gb = td.scale_volume_grid(tcfg, tp, tb, 300 ** 3)
    assert int(np.prod(gcfg.world_size)) > 256 ** 3
    assert gcfg.mask_cache_world_size == tcfg.mask_cache_world_size
    assert gb["mask_cache"] is tb["mask_cache"]


@pytest.mark.parametrize("downrate,chunk", [(1, 10000), (2, 7)])
def test_voxel_count_views_matches_jax(downrate, chunk):
    cfg, _, _ = _scene()
    views = _views(4)
    ro = [v[0] for v in views]
    rd = [v[1] for v in views]
    want = np.asarray(jd.voxel_count_views(cfg, ro, rd, None, 0.2, 6.0, 0.5,
                                           downrate=downrate))
    tcfg = td.make_config(**jd.get_kwargs(cfg))
    got = td.voxel_count_views(tcfg, [torch.as_tensor(a) for a in ro],
                               [torch.as_tensor(a) for a in rd], 0.2, 0.5,
                               downrate=downrate, chunk=chunk)
    assert got.shape == want.shape == (*cfg.world_size, 1)
    assert want.max() >= 2 and (want == 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dense", [True, False])
def test_tv_grads_match_jax(dense):
    cfg, params, _ = _scene()
    rng = np.random.default_rng(6)
    tcfg = td.make_config(**jd.get_kwargs(cfg))
    tp = weights.dvgo_from_numpy(params, {}, device="cpu")[0]
    for name, jfn in (("density", jd.density_tv_grad),
                      ("k0", jd.k0_tv_grad)):
        g = rng.normal(size=params[name].shape).astype(np.float32)
        g[rng.uniform(size=g.shape) < 0.5] = 0.0
        want = np.asarray(jfn(cfg, jax.tree.map(jnp.asarray, params), 0.3,
                              dense, 512, jnp.asarray(g)))
        got = common.grid_tv_grad(
            getattr(tcfg, f"{name}_type"), tp[name],
            *td.tv_weights(tcfg, 0.3, 512),
            None if dense else torch.as_tensor(g)).numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0,
                                   err_msg=name)


def test_init_with_a_mask_matches_jax():
    cfg, _, _ = _scene()
    mask = np.random.default_rng(7).uniform(size=cfg.world_size) < 0.4
    jp, jb = jd.init(cfg, jax.random.PRNGKey(1), init_mask=mask)
    tcfg = td.make_config(**jd.get_kwargs(cfg))
    for m in (mask, torch.as_tensor(mask)):
        tp, tb = td.init(tcfg, init_mask=m, device="cpu")
        assert tb["mask_cache"].dtype == torch.bool
        np.testing.assert_array_equal(tb["mask_cache"].numpy(),
                                      np.asarray(jb["mask_cache"]))
        for k in ("density", "k0"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def _coarse_npz(path, seed=0):
    cfg, params, buffers = _scene(seed, rgbnet_dim=0, world=(12, 12, 12),
                                  alpha_init=1e-2)
    dens = params["density"].copy()
    dens[:4] = dens[-3:] = dens[:, :2] = dens[:, :, -5:] = -20.0
    dens[:, :, :1] = -20.0
    params["density"] = dens
    jc.save_checkpoint(path, jd.get_kwargs(cfg), params, buffers)
    return cfg, params


def test_coarse_masks_and_box_match_jax(tmp_path):
    path = str(tmp_path / "coarse_last.npz")
    cfg, params = _coarse_npz(path)
    want = jc.mask_from_coarse_checkpoint(path, 1e-3)
    got = tc.mask_from_coarse_checkpoint(path, 1e-3, device="cpu")
    assert got[0].dtype == torch.bool
    assert 0 < want[0].sum() < want[0].size
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    # the box: a tight one, and the full box when nothing is above
    for thres in (1e-3, 0.3, 2.0):
        jb = jt.compute_bbox_by_coarse_geo(jd, path, thres)
        tb = tt.compute_bbox_by_coarse_geo(td, path, thres, device="cpu")
        for a, b in zip(tb, jb):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, np.asarray(b))
    lo, hi = tt.compute_bbox_by_coarse_geo(td, path, 1e-3, device="cpu")
    assert (np.asarray(cfg.xyz_min) < lo).all() and \
        (hi < np.asarray(cfg.xyz_max)).all()

    # a reference torch .tar of the same density
    tar = str(tmp_path / "coarse.tar")
    dens = torch.as_tensor(params["density"][..., 0])[None, None]
    torch.save({"model_state_dict": {
        "density.grid": dens, "act_shift": torch.tensor([cfg.act_shift])},
        "model_kwargs": {"voxel_size_ratio": cfg.voxel_size_ratio,
                         "xyz_min": list(cfg.xyz_min),
                         "xyz_max": list(cfg.xyz_max)}}, tar)
    want = jc.mask_from_coarse_torch_checkpoint(tar, 1e-3)
    got = tc.mask_from_coarse_torch_checkpoint(tar, 1e-3, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[0].numpy(),
                                  tc.mask_from_coarse_checkpoint(
                                      path, 1e-3, device="cpu")[0].numpy())
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_coarse_mask_on_the_fine_grid_matches_jax(tmp_path):
    """The coarse mask resampled by nearest lookup onto a fine grid over
    another box, as the fine stage and ``--ftdvcoa_path`` start."""
    path = str(tmp_path / "coarse_last.npz")
    _coarse_npz(path)
    fine = jd.make_config(xyz_min=[-0.9, -0.7, -0.5], xyz_max=[0.8, 0.8, 0.6],
                          num_voxels=15 ** 3, num_voxels_base=15 ** 3,
                          alpha_init=1e-2)
    mask, m_min, m_max = jc.mask_from_coarse_checkpoint(path, 1e-3)
    xyz = np.stack(np.meshgrid(*[np.linspace(
        fine.xyz_min[d], fine.xyz_max[d], fine.mask_cache_world_size[d])
        for d in range(3)], indexing="ij"), -1)
    from fourk_nerf_tpu.ops import grid_sample as jgs
    want = np.asarray(jgs.nearest_mask_lookup(
        jnp.asarray(mask), jnp.asarray(xyz, dtype=jnp.float32),
        jnp.asarray(m_min, dtype=jnp.float32),
        jnp.asarray(m_max, dtype=jnp.float32)))
    got = tt.coarse_mask_on_grid(td.make_config(**jd.get_kwargs(fine)), path,
                                 1e-3, device="cpu")
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)
