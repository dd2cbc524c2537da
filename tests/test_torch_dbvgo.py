"""Port parity of DirectBiVoxGO (``models/dbvgo.py``) against the JAX
package's, float32 on the CPU, params drawn with numpy and handed to both,
on rays from cameras outside the foreground cube (the Blender sphere at
radius 4 around a cube of half-side 1.5).

Tolerances: the configs and the layouts are equal; the background samples
1e-5 (the inverted-sphere map divides by norms, computed in another order
of operations); the forward 1e-5 on every output, its gradients within
1e-5 of each leaf's largest entry (as the other models' parity tests).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import dbvgo as jd
from fourk_nerf_tpu.ops import rays as jrays
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dbvgo as td
from fourk_nerf_torch.ops import render
from fourk_nerf_torch.tools import tiny_scene

BOX = dict(xyz_min=[-1.5, -1.4, -1.6], xyz_max=[1.5, 1.6, 1.4])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**kw):
    return {**BOX, "num_voxels": 10 ** 3, "num_voxels_base": 10 ** 3,
            "alpha_init": 1e-2, "rgbnet_dim": 4, "rgbnet_width": 16,
            "viewbase_pe": 2, "fast_color_thres": 1e-4, **kw}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


def _rays(n=96, seed=0):
    """Rays of a 16x16 view from each of two Blender-sphere poses."""
    poses = tiny_scene.bounded_poses(2)
    f = tiny_scene.blender_focal(16)
    K = np.array([[f, 0, 8.0], [0, f, 8.0], [0, 0, 1]], np.float32)
    out = [[], [], []]
    for c2w in poses:
        for i, a in enumerate(jrays.get_rays_of_a_view(
                16, 16, K, c2w[:3, :4], ndc=False, inverse_y=False,
                flip_x=False, flip_y=False)):
            out[i].append(np.asarray(a).reshape(-1, 3))
    idx = np.random.default_rng(seed).permutation(512)[:n]
    return [np.concatenate(a)[idx].astype(np.float32) for a in out]


def _params(jcfg, seed=0):
    params, buffers = jd.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = _np(params)
    for f in ("fg", "bg"):
        params[f]["density"] = rng.normal(
            -1, 2, params[f]["density"].shape).astype(np.float32)
        params[f]["k0"] = rng.normal(0, 1, params[f]["k0"].shape).astype(
            np.float32)
    buffers = _np(buffers)
    buffers["mask_cache_bg"] = rng.uniform(
        size=buffers["mask_cache_bg"].shape) < 0.9
    return params, buffers


def test_config_and_init_match_jax():
    for kw in (_kw(), _kw(bg_use_mlp=False, rgbnet_dim=0, bg_preserve=0.3,
                          mask_cache_world_size=(5, 6, 7))):
        j, t = jd.make_config(**kw), td.make_config(**kw)
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == \
            {f: getattr(t, f) for f in t.__dataclass_fields__}
        assert td.get_kwargs(t) == jd.get_kwargs(j)
        assert td.make_config(**td.get_kwargs(t)) == t
        assert (t.n_samples_fg(0.5), t.n_samples_bg(0.5), t.act_shift) == \
            (j.n_samples_fg(0.5), j.n_samples_bg(0.5), j.act_shift)
        jp, jb = jax.tree.map(lambda a: np.zeros(a.shape), jax.eval_shape(
            functools.partial(jd.init, j), jax.random.PRNGKey(0)))
        tp, tb = td.init(t, generator=torch.Generator().manual_seed(0),
                         device="cpu")
        assert {k: v.shape for k, v in _flat(tp).items()} == \
            {k: v.shape for k, v in _flat(jp).items()}
        assert {k: v.shape for k, v in _flat(tb).items()} == \
            {k: v.shape for k, v in _flat(jb).items()}
        assert all(v.dtype == torch.bool and bool(v.all())
                   for v in tb.values())
    p, _ = td.init(td.make_config(**_kw(bg_use_mlp=False)),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    assert "rgbnet" in p["fg"] and "rgbnet" not in p["bg"]
    assert p["bg"]["k0"].shape[-1] == 3


def test_background_samples_match_jax():
    ro, rd, _ = _rays()
    d = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    o = ro / 1.5
    mn, mx = -np.ones(3, np.float32), np.ones(3, np.float32)
    _, t_max = render.ray_aabb(torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(mn), torch.as_tensor(mx), 0.0,
                               2 * np.sqrt(3))
    want = jax.jit(lambda a, b, t: jd.sample_bg_pts(a, b, t, 0.5, 40))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max.numpy()))
    got = td.sample_bg_pts(torch.as_tensor(o), torch.as_tensor(d), t_max, 0.5,
                           40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # the first sample of a ray that crosses the cube is its exit point
    cross = (t_max > 0) & (t_max < 2 * np.sqrt(3) - 1e-3)
    assert bool(cross.any())
    torch.testing.assert_close(got[cross, 0].abs().amax(-1),
                               torch.ones(int(cross.sum())))


@pytest.mark.parametrize("kw", [_kw(), _kw(bg_use_mlp=False,
                                           fast_color_thres=0.0)])
def test_forward_and_gradients_match_jax(kw):
    jcfg, tcfg = jd.make_config(**kw), td.make_config(**kw)
    params, buffers = _params(jcfg)
    rays = _rays()
    target = np.random.default_rng(1).uniform(size=(96, 3)).astype(
        np.float32)
    jb = jax.tree.map(jnp.asarray, buffers)

    def jloss(p):
        out = jd.forward(jcfg, p, jb, *(jnp.asarray(a) for a in rays),
                         stepsize=0.5, bg=1.0, render_depth=True)
        return jnp.mean((out["rgb_marched"] - target) ** 2), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tp, tb = weights.dbvgo_from_numpy(params, buffers, device="cpu")
    leaves = [v.requires_grad_(True) for v in
              (tp[f][g] for f in ("fg", "bg") for g in ("density", "k0"))]
    tout = td.forward(tcfg, tp, tb, *(torch.as_tensor(a) for a in rays),
                      stepsize=0.5, bg=1.0, render_depth=True)
    for k in ("rgb_marched", "alphainv_last", "weights_fg", "weights_bg",
              "raw_rgb", "depth", "s"):
        np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert tout["n_max"] == jout["n_max"]
    # fg over bg: the transmittance is the product of the two fields'
    torch.testing.assert_close(
        tout["alphainv_last"],
        tout["alphainv_last_fg"] * tout["alphainv_last_bg"])
    assert float(tout["weights_fg"].sum()) > 1.0 and \
        float(tout["weights_bg"].sum()) > 1.0
    loss = ((tout["rgb_marched"] - torch.as_tensor(target)) ** 2).mean()
    grads = torch.autograd.grad(loss, leaves)
    names = [f"{f}/{g}" for f in ("fg", "bg") for g in ("density", "k0")]
    jflat = _flat(jg)
    for name, got in zip(names, grads):
        want = jflat[name]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_forward_with_tensorf_fields_matches_jax():
    kw = _kw(density_type="TensoRFGrid", k0_type="TensoRFGrid",
             density_config={"n_comp": 3}, k0_config={"n_comp": 4})
    jcfg, tcfg = jd.make_config(**kw), td.make_config(**kw)
    params, buffers = jd.init(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.7, a.shape).astype(np.float32), params)
    buffers = _np(buffers)
    rays = _rays(48, 1)
    jout = jax.jit(functools.partial(jd.forward, jcfg, stepsize=0.5, bg=1.0))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, buffers),
        *(jnp.asarray(a) for a in rays))
    tp, tb = weights.dbvgo_from_numpy(params, buffers, device="cpu")
    tout = td.forward(tcfg, tp, tb, *(torch.as_tensor(a) for a in rays),
                      stepsize=0.5, bg=1.0)
    for k in ("rgb_marched", "alphainv_last", "weights_bg"):
        np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
