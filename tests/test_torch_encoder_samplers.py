"""Port parity of the encoder's patch samplers (``patch_simg``,
``patch_mimg``, ``patch_inmask``) and of the samplers' inputs against the
JAX package's ``trainer.make_batch_sampler`` / ``gather_training_rays``:
every draw over several epochs equal, the per-view hit maps and the
``in_maskcache`` rays of a DirectVoxGO equal, and a few ``patch_inmask``
training steps from one checkpoint (``--ft_path``) on the tiny bounded
scene: the losses 1e-5 relative, the final params within 1e-4 but for a
share under 1e-3 of entries (MaskedAdam's first moves are ``lr *
sign(g)``), the rgbnet 1e-5."""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.models import dvgo as jd
from fourk_nerf_tpu.train import checkpoints as jc, trainer as jt
from fourk_nerf_torch import config as tconfig, weights
from fourk_nerf_torch.models import dvgo as td
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import trainer as tt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "syn", "syn_default.py")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hits(rng, V, H, W):
    hit = np.zeros((V, H, W), bool)
    hit[0, 3:7, 30:33] = True        # view 0: a spot in one patch
    hit[2] = rng.uniform(size=(H, W)) < 0.02
    return hit                        # view 1: no hit at all


@pytest.mark.parametrize("sampler,n_rand,hw", [
    ("patch_simg", 1024, (40, 36)), ("patch_mimg", 1024, (40, 36)),
    ("patch_inmask", 1024, (40, 36)), ("patch_mimg", 8192, (40, 36)),
    ("patch_inmask", 64, (12, 20))])
def test_patch_draws_match_jax(sampler, n_rand, hw):
    V, (H, W) = 3, hw
    rng = np.random.default_rng(0)
    hit = _hits(rng, V, H, W)
    flat = {"rgb": np.zeros((V, H, W, 3), np.float32)}
    want = jt.make_batch_sampler(sampler, flat, n_rand, 5, hit=hit)
    got = tt.make_batch_sampler(sampler, {"rgb": torch.as_tensor(
        flat["rgb"])}, n_rand, 5, hit=hit)
    assert got.patch == want.patch
    draws = [got(s) for s in range(60)]
    assert draws == [want(s) for s in range(60)]
    assert all(kind == "patch" for kind, _ in draws)
    views = {v for _, (v, _, _) in draws}
    if sampler == "patch_inmask":
        assert 1 not in views  # the view without hits is never drawn
    else:
        assert views == {0, 1, 2}
    # replayed from any step, as a resumed run draws
    again = tt.make_batch_sampler(sampler, {"rgb": torch.as_tensor(
        flat["rgb"])}, n_rand, 5, hit=hit)
    assert [again(s) for s in (37, 3, 59)] == [draws[s] for s in (37, 3, 59)]


def test_inmask_never_filters_to_nothing():
    flat = {"rgb": torch.zeros((2, 16, 16, 3))}
    hit = np.zeros((2, 16, 16), bool)
    got = tt.make_batch_sampler("patch_inmask", flat, 512, 1, hit=hit)
    want = jt.make_batch_sampler("patch_inmask", {"rgb": np.zeros(
        (2, 16, 16, 3))}, 512, 1, hit=hit)
    assert [got(s) for s in range(12)] == [want(s) for s in range(12)]
    assert {v for _, (v, _, _) in (got(s) for s in range(12))} == {0, 1}


def test_patch_gather_matches_jax_slices():
    rng = np.random.default_rng(1)
    flat = {k: rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
            for k in tt._RAY_KEYS}
    tflat = {k: torch.as_tensor(v) for k, v in flat.items()}
    got = tt.gather_batch(tflat, "patch", (1, 8, 16), 8)
    for g, k in zip(got, tt._RAY_KEYS):
        np.testing.assert_array_equal(
            g.numpy(), flat[k][1, 8:16, 16:24].reshape(-1, 3))


def test_patch_box_draws_gather_whole_patches():
    """The ``patch_box`` sampler's draws go through the patch gather: the
    JAX sampler's draws, ``P x P`` rays each (P = 8 at N_rand 64)."""
    rng = np.random.default_rng(2)
    flat = {k: rng.normal(size=(2, 12, 20, 3)).astype(np.float32)
            for k in tt._RAY_KEYS}
    want = jt.make_batch_sampler("patch_box", flat, 64, 0)
    got = tt.make_batch_sampler("patch_box", {k: torch.as_tensor(v) for k, v
                                              in flat.items()}, 64, 0)
    assert got.patch == want.patch == 8
    for step in range(12):
        kind, (v, r, c) = got(step)
        assert (kind, (v, r, c)) == want(step)
        rays = tt.gather_batch({k: torch.as_tensor(x) for k, x in
                                flat.items()}, kind, (v, r, c), got.patch)
        np.testing.assert_array_equal(
            rays[3].numpy(), flat["rgb"][v, r:r + 8, c:c + 8].reshape(-1, 3))


def _bounded_model(seed=2):
    """A JAX DirectVoxGO over the tiny bounded scene's box: numpy-drawn
    grids and rgbnet, its mask a ball of radius 0.9."""
    data = tiny_scene.bounded_scene()
    cfg = jd.make_config(xyz_min=[-1.6] * 3, xyz_max=[1.6] * 3,
                         num_voxels=14 ** 3, num_voxels_base=14 ** 3,
                         alpha_init=1e-2, rgbnet_dim=6, rgbnet_width=16,
                         fast_color_thres=1e-4)
    params, buffers = jd.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    params["density"] = rng.normal(-2, 1, params["density"].shape).astype(
        np.float32)
    params["k0"] = rng.normal(0, 1, params["k0"].shape).astype(np.float32)
    for k, v in params["rgbnet"].items():
        params["rgbnet"][k] = rng.normal(
            0, 0.1 if k[0] == "b" else 1 / np.sqrt(v.shape[0]),
            v.shape).astype(np.float32)
    g = np.stack(np.meshgrid(*[np.linspace(-1.6, 1.6, n)
                               for n in cfg.world_size], indexing="ij"), -1)
    buffers = {"mask_cache": (g ** 2).sum(-1) < 0.9 ** 2}
    return data, cfg, params, buffers


def _cfgs(tmp, **fine_train):
    out = []
    for pkg, mod in (("fourk_nerf_tpu", jconfig), ("fourk_nerf_torch",
                                                   tconfig)):
        cfg = tiny_scene.apply_overrides(
            mod.load_config(os.path.join(ROOT, pkg, CFG)), str(tmp / pkg),
            "samplers", tiny_scene.BOUNDED_OVERRIDES)
        cfg.coarse_train.N_iters = 0
        cfg.fine_train.update(fine_train)
        out.append(cfg)
    return out


@pytest.mark.parametrize("sampler", ["in_maskcache", "patch_inmask"])
def test_sampler_inputs_match_jax(tmp_path, sampler):
    data, cfg, params, buffers = _bounded_model()
    jcfg, tcfg = _cfgs(tmp_path, ray_sampler=sampler)
    rk = dict(near=2.0, far=6.0, stepsize=0.5)
    jflat, _, _ = jt.gather_training_rays(
        jcfg, jcfg.fine_train, data, model_mod=jd,
        model_state=(cfg, params, jax.tree.map(jnp.asarray, buffers)),
        render_kwargs=rk)
    tmc = td.make_config(**jd.get_kwargs(cfg))
    _, tb = weights.dvgo_from_numpy({}, buffers, device="cpu")
    flat, lists = tt.gather_training_rays(
        tcfg, tcfg.fine_train, data, "cpu", model=(td, tmc, tb),
        render_kwargs=rk)
    if sampler == "patch_inmask":
        hit = flat.pop("hit")
        want_hit = jflat.pop("_hit")
        assert 0 < want_hit.sum() < want_hit.size
        np.testing.assert_array_equal(hit, want_hit)
    n = 0
    for k in tt._RAY_KEYS:
        assert tuple(flat[k].shape) == jflat[k].shape, k
        np.testing.assert_allclose(flat[k].numpy(), jflat[k], atol=1e-6,
                                   rtol=0, err_msg=k)
        n = jflat[k].shape[0]
    if sampler == "in_maskcache":
        assert 0 < n < sum(int(np.prod(data["HW"][i]))
                           for i in data["i_train"])
    assert len(lists["rays_o"]) == len(data["i_train"])


def test_patch_inmask_steps_match_jax(tmp_path):
    data, cfg, params, buffers = _bounded_model()
    ckpt = str(tmp_path / "start.npz")
    jc.save_checkpoint(ckpt, jd.get_kwargs(cfg), params, buffers)
    jcfg, tcfg = _cfgs(tmp_path, ray_sampler="patch_inmask", N_iters=5,
                       pg_scale=[], N_rand=256)
    args = types.SimpleNamespace(seed=3, no_reload=False,
                                 no_reload_optimizer=False, ft_path=ckpt,
                                 i_print=1, i_val=0, i_weights=0)
    rows = [[], []]
    w = [types.SimpleNamespace(scalar=lambda tag, v, step, r=r: r.append(
        float(v)) if tag == "train/loss" else None) for r in rows]
    _, _, jp, jb = jt.train(args, jcfg, data, writer=w[0])
    _, _, tp, tb = tt.train(args, tcfg, data, writer=w[1], device="cpu")
    assert len(rows[0]) == 5
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-5)
    np.testing.assert_array_equal(tb["mask_cache"].numpy(),
                                  np.asarray(jb["mask_cache"]))
    for k in ("density", "k0"):
        d = np.abs(tp[k].numpy() - np.asarray(jp[k]))
        assert np.mean(d > 1e-4) < 1e-3, (k, np.mean(d > 1e-4))
        assert np.any(tp[k].numpy() != params[k]), k
    for k, v in jp["rgbnet"].items():
        np.testing.assert_allclose(tp["rgbnet"][k].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=0, err_msg=k)
