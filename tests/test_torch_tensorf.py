"""Port parity of the TensoRF grids (``ops/tensorf.py``, the
``common.grid_*`` dispatch) and of the three grid models with TensoRF grids
against the JAX package, float32 on the CPU, factors drawn with numpy and
handed to both.

Tolerances: the ops, the dense grid and the resize repeat the JAX
package's arithmetic in its order: 1e-6. The TV gradient 1e-7 absolute
(its entries are of order 1e-3). The model forwards 1e-5 on every output
(as the dense-grid parity tests' own), their gradients within 1e-5 of each
leaf's largest entry. The training loop: per-step losses 1e-4 relative
(as ``test_torch_train``'s); the factors after it are held by what they
render on 256 rays, 1e-2 max and 5e-4 mean absolute (measured 2.1e-3 and
9.4e-5): entry by entry they differ, since a texel that only samples of
~0 weight touch gets a gradient of rounding size, whose sign MaskedAdam
turns into a step of the full lr (0.1) in either direction.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.models import common as jcommon, dcvgo as jdc, \
    dmpigo as jdm, dvgo as jdv
from fourk_nerf_tpu.ops import rays as jrays, tensorf as jtf
from fourk_nerf_tpu.train import checkpoints as jc, trainer as jt
from fourk_nerf_torch import config as tconfig, pipeline, weights
from fourk_nerf_torch.models import common as tcommon, dcvgo as tdc, \
    dmpigo as tdm, dvgo as tdv
from fourk_nerf_torch.ops import tensorf as ttf
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import checkpoints as tc, trainer as tt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TENSORF = dict(density_type="TensoRFGrid", k0_type="TensoRFGrid",
               density_config={"n_comp": 4}, k0_config={"n_comp": 6})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _factors(rng, channels, ws, n_comp, n_comp_xy=None, scale=0.5):
    """Numpy factors of the JAX layout (a larger spread than the init's
    0.1, so that products and the TV's smooth-L1 both sides show)."""
    X, Y, Z = ws
    R, Rxy = n_comp, n_comp if n_comp_xy is None else n_comp_xy
    p = {"xy_plane": (X, Y, Rxy), "xz_plane": (X, Z, R),
         "yz_plane": (Y, Z, R), "x_vec": (X, R), "y_vec": (Y, R),
         "z_vec": (Z, Rxy)}
    p = {k: rng.normal(0, scale, s).astype(np.float32) for k, s in p.items()}
    if channels > 1:
        p["f_vec"] = rng.normal(0, 0.3, (2 * R + Rxy, channels)).astype(
            np.float32)
    return p


def _t(tree):
    return weights.to_torch(tree, "cpu")


def _close(got, want, atol, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], atol, f"{what}/{k}")
        return
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("channels,n_comp_xy", [(1, None), (5, 3)])
def test_ops_match_jax(channels, n_comp_xy):
    rng = np.random.default_rng(channels)
    ws = (7, 6, 5)
    p = _factors(rng, channels, ws, 4, n_comp_xy)
    # points inside and outside the unit cube (zeros padding)
    ind01 = rng.uniform(-0.1, 1.1, (200, 3)).astype(np.float32)
    tp = _t(p)
    new = (11, 4, 9)
    q = ind01.reshape(10, 20, 3)

    @jax.jit
    def ref(p, ind01, q):  # one compile for the JAX references
        return (jtf.bilinear_sample(p["xy_plane"], ind01[:, :2]),
                jtf.linear_sample(p["z_vec"], ind01[:, 2]),
                jtf.tensorf_query(p, q), jtf.tensorf_dense(p, channels),
                jtf.tensorf_resize(p, new))

    jb, jl, jq, jd, jr = ref(jax.tree.map(jnp.asarray, p),
                             jnp.asarray(ind01), jnp.asarray(q))
    _close(ttf.bilinear_sample(tp["xy_plane"], torch.as_tensor(ind01[:, :2])),
           jb, 1e-6, "bilinear")
    _close(ttf.linear_sample(tp["z_vec"], torch.as_tensor(ind01[:, 2])), jl,
           1e-6, "linear")
    _close(ttf.tensorf_query(tp, torch.as_tensor(q)), jq, 1e-6, "query")
    _close(ttf.tensorf_dense(tp, channels), jd, 1e-5, "dense")
    # the dense grid is what the query gives at the voxel centres
    u = [np.linspace(0, 1, n, dtype=np.float32) for n in ws]
    vox = np.stack(np.meshgrid(*u, indexing="ij"), -1)
    _close(ttf.tensorf_query(tp, torch.as_tensor(vox)),
           ttf.tensorf_dense(tp, channels), 1e-5, "dense vs query")
    _close(ttf.tensorf_resize(tp, new), jr, 1e-6, "resize")


def test_tv_gradient_matches_jax():
    rng = np.random.default_rng(2)
    p = _factors(rng, 5, (7, 6, 5), 4, scale=1.0)  # |d| on both sides of 1
    w = (0.3, 0.2, 0.7)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jtf.tensorf_tv_loss(q, *w)))(jax.tree.map(jnp.asarray, p))
    tl = ttf.tensorf_tv_loss(_t(p), *w)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _close(ttf.tensorf_tv_grad(_t(p), *w), jg, 1e-6, "tv grad")
    assert float(np.abs(_np(jg["xy_plane"])).max()) > 0.1


def test_grid_dispatch_and_init():
    g = torch.Generator().manual_seed(0)
    dense = tcommon.grid_init("DenseGrid", 3, (4, 5, 6), generator=g,
                              device="cpu")
    assert tuple(dense.shape) == (4, 5, 6, 3) and not bool(dense.any())
    fac = tcommon.grid_init("TensoRFGrid", 3, (4, 5, 6),
                            (("n_comp", 2), ("n_comp_xy", 3)), generator=g,
                            device="cpu")
    jfac = jax.eval_shape(lambda k: jcommon.grid_init(
        "TensoRFGrid", k, 3, (4, 5, 6), (("n_comp", 2), ("n_comp_xy", 3))),
        jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in fac.items()} == \
        {k: v.shape for k, v in jfac.items()}
    bound = np.sqrt(6.0 / (6 * 7))
    assert float(fac["f_vec"].abs().max()) <= bound
    one = tcommon.grid_init("TensoRFGrid", 1, (4, 5, 6), (("n_comp", 2),),
                            generator=g, device="cpu")
    assert "f_vec" not in one
    with pytest.raises(NotImplementedError):
        tcommon.grid_query("HashGrid", dense, torch.zeros(2, 3))
    # each dispatch against the JAX package's, both grid types
    rng = np.random.default_rng(3)
    grids = {"DenseGrid": rng.normal(size=(4, 5, 6, 3)).astype(np.float32),
             "TensoRFGrid": _factors(rng, 3, (4, 5, 6), 2)}
    pts = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    for gt, grid in grids.items():
        ref = jax.jit(lambda g, x: (
            jcommon.grid_query(gt, g, x), jcommon.grid_dense(gt, g, 3)))
        jq, jd = ref(jax.tree.map(jnp.asarray, grid), jnp.asarray(pts))
        _close(tcommon.grid_query(gt, _t(grid), torch.as_tensor(pts)), jq,
               1e-6, gt)
        _close(tcommon.grid_dense(gt, _t(grid), 3), jd, 1e-5, gt)
        _close(tcommon.grid_resize(gt, _t(grid), (7, 3, 8)),
               jax.jit(lambda g: jcommon.grid_resize(gt, g, (7, 3, 8)))(
                   jax.tree.map(jnp.asarray, grid)), 1e-5, gt)


def _rays(seed, n, ndc):
    data = tiny_scene.scene(seed)
    ro, rd, vd = (np.asarray(a).reshape(-1, 3)[::3][:n]
                  for a in jrays.get_rays_of_a_view(
                      24, 32, data["Ks"][1], data["poses"][1], ndc=ndc,
                      inverse_y=False, flip_x=False, flip_y=False))
    return ro, rd, vd


def _model(family, seed=0):
    """(jax module, torch module, config kwargs, forward kwargs, rays)."""
    rng = np.random.default_rng(seed)
    if family == "dmpigo":
        kw = dict(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
                  num_voxels=12 * 12 * 8, mpi_depth=8, rgbnet_dim=6,
                  rgbnet_width=16, fast_color_thres=1.0 / 40, **TENSORF)
        rays = _rays(seed, 64, True)
        fkw = dict(stepsize=1.0, bg=0.5, ndc_planes=True)
        return jdm, tdm, kw, fkw, rays
    # bounded and unbounded scenes around the tiny scene's cameras
    kw = dict(xyz_min=[-0.6, -0.5, -0.4], xyz_max=[0.5, 0.6, 0.7],
              num_voxels=12 ** 3, num_voxels_base=12 ** 3, alpha_init=1e-2,
              rgbnet_dim=6, rgbnet_width=16, fast_color_thres=1e-4, **TENSORF)
    ro, rd, vd = _rays(seed, 64, False)
    ro = ro + rng.normal(0, 0.01, ro.shape).astype(np.float32)
    if family == "dvgo":
        return jdv, tdv, kw, dict(stepsize=0.5, near=0.2, far=3.0,
                                  bg=1.0), (ro, rd, vd)
    return jdc, tdc, kw, dict(stepsize=0.5, bg=0.0), (ro, rd, vd)


def _init_params(jmod, jcfg, seed):
    """The JAX init's layout with numpy-drawn factors and rgbnet."""
    params, buffers = jmod.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    params = _np(params)
    for g in ("density", "k0"):
        params[g] = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
                     for k, v in params[g].items()}
    params["density"]["xy_plane"] += 1.0  # a visible density
    return params, _np(buffers)


@pytest.mark.parametrize("family", ["dmpigo", "dvgo", "dcvgo"])
def test_forward_and_gradients_match_jax(family):
    jmod, tmod, kw, fkw, rays = _model(family)
    jcfg, tcfg = jmod.make_config(**kw), tmod.make_config(**kw)
    params, buffers = _init_params(jmod, jcfg, 0)
    ro, rd, vd = (jnp.asarray(a) for a in rays)
    target = np.random.default_rng(1).uniform(size=(rays[0].shape[0], 3))
    jb = jax.tree.map(jnp.asarray, buffers)

    def jloss(p):
        out = jmod.forward(jcfg, p, jb, ro, rd, vd, render_depth=True, **fkw)
        return jnp.mean((out["rgb_marched"] - target) ** 2), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    jg = _np(jg)
    tp, tb = _t(params), _t(buffers)
    tout = tmod.forward(tcfg, tp, tb, *(torch.as_tensor(np.asarray(a))
                                        for a in rays),
                        render_depth=True, **fkw)
    for k in ("rgb_marched", "alphainv_last", "weights", "raw_alpha",
              "depth"):
        _close(tout[k], jout[k], 1e-5, k)
    assert float(tout["weights"].sum()) > 1.0  # not an empty scene
    live = {g: {k: v.requires_grad_(True) for k, v in tp[g].items()}
            for g in ("density", "k0")}
    out = tmod.forward(tcfg, {**tp, **live}, tb,
                       *(torch.as_tensor(np.asarray(a)) for a in rays),
                       **fkw)
    loss = ((out["rgb_marched"] - torch.as_tensor(target).float()) ** 2
            ).mean()
    leaves = [v for g in live.values() for v in g.values()]
    tg = dict(zip([f"{g}/{k}" for g in live for k in live[g]],
                  torch.autograd.grad(loss, leaves)))
    for name, got in tg.items():
        g, k = name.split("/")
        want = jg[g][k]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("family", ["dmpigo", "dvgo"])
def test_scaling_occupancy_and_tv_match_jax(family):
    jmod, tmod, kw, _, _ = _model(family)
    jcfg, tcfg = jmod.make_config(**kw), tmod.make_config(**kw)
    params, buffers = _init_params(jmod, jcfg, 1)
    jp, jb = (jax.tree.map(jnp.asarray, t) for t in (params, buffers))
    tp, tb = _t(params), _t(buffers)
    args = (3000,) if family == "dvgo" else (3000, jcfg.mpi_depth)

    @jax.jit
    def ref(p, b):  # one compile: the occupancy, the scaling, the TVs
        return (jmod.update_occupancy_cache(jcfg, p, b)["mask_cache"],
                jmod.scale_volume_grid(jcfg, p, b, *args)[1:],
                jmod.density_tv_grad(jcfg, p, 0.5, True, 8, None),
                jmod.k0_tv_grad(jcfg, p, 0.3, True, 8, None))

    jm, (jp2, jb2), jtvd, jtvk = ref(jp, jb)
    # the occupancy renewal queries the factors at the mask's voxels
    _close(tmod.update_occupancy_cache(tcfg, tp, tb)["mask_cache"], jm, 0,
           "occupancy")
    tc2, tp2, tb2 = tmod.scale_volume_grid(tcfg, tp, tb, *args)
    assert tc2.world_size == tmod.make_config(
        **{**kw, "num_voxels": 3000}).world_size != tcfg.world_size
    assert tuple(tp2["density"]["xy_plane"].shape[:2]) == \
        tuple(tc2.world_size[:2])
    _close({g: tp2[g] for g in ("density", "k0")},
           {g: jp2[g] for g in ("density", "k0")}, 1e-5, "scaled")
    _close(tb2["mask_cache"], jb2["mask_cache"], 0, "scaled mask")
    _close(tcommon.grid_tv_grad(tcfg.density_type, tp["density"],
                                *tmod.tv_weights(tcfg, 0.5, 8)), jtvd, 1e-7,
           "density tv")
    _close(tcommon.grid_tv_grad(tcfg.k0_type, tp["k0"],
                                *tmod.tv_weights(tcfg, 0.3, 8)), jtvk, 1e-7,
           "k0 tv")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


class _Recorder:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def losses(self):
        return [v for tag, v, _ in self.rows if tag == "train/loss"]


def _tiny_cfgs(tmp_path, **fine_train):
    cfg_path = os.path.join("configs", "llff", "fern_lg_pretrain.py")
    over = {**tiny_scene.OVERRIDES,
            "fine_train": {**tiny_scene.OVERRIDES["fine_train"],
                           **fine_train},
            "fine_model_and_render": {
                **tiny_scene.OVERRIDES["fine_model_and_render"], **TENSORF}}
    j = tiny_scene.apply_overrides(
        jconfig.load_config(os.path.join(ROOT, "fourk_nerf_tpu", cfg_path)),
        str(tmp_path / "jax"), "tiny", over)
    t = tiny_scene.apply_overrides(
        tconfig.load_config(os.path.join(ROOT, "fourk_nerf_torch", cfg_path)),
        str(tmp_path / "torch"), "tiny", over)
    return j, t


def test_tv_step_on_factors_and_the_jax_fault(tmp_path):
    """TV on TensoRF factors in a training step: the port adds the autograd
    gradient of the factor loss to each factor's gradient, what the JAX
    package's ``_tv_dispatch`` computes. The JAX train step itself adds the
    two gradient trees with ``+`` and so raises a TypeError on a TensoRF
    grid (a fault of the JAX package, not copied)."""
    j, t = _tiny_cfgs(tmp_path, weight_tv_density=1e-2, weight_tv_k0=1e-3)
    data = tiny_scene.scene()
    xyz = jt.compute_bbox_by_cam_frustrm(
        j, data["HW"], data["Ks"], data["poses"], data["i_train"], 0.0, 1.0)
    kw = dict(j.fine_model_and_render)
    mcfg = jt._make_cfg(jdm, j, *xyz, kw.pop("num_voxels"), kw)
    params, buffers = _init_params(jdm, mcfg, 3)
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "rand_bkgd": False,
          "stepsize": 1.0, "ndc_planes": True}
    ro, rd, vd = _rays(0, 96, True)
    target = data["images"][1].reshape(-1, 3)[::3][:96]
    batch = tuple(jnp.asarray(a) for a in (ro, rd, vd, target))
    jp, jb = (jax.tree.map(jnp.asarray, x) for x in (params, buffers))
    jstep = jt.make_train_step(jdm, mcfg, j.fine_train, render_kwargs=rk,
                               skip_zero_grad=frozenset(), donate=False)
    with pytest.raises(TypeError, match="dict"):
        jstep(jp, jb, jt.optim.init_state(jp), batch,
              jt.optim.build_group_lrs(j.fine_train, params), None,
              jax.random.PRNGKey(0), apply_tv=True, tv_dense=True)

    @jax.jit
    def jgrads(p):
        def loss(p):
            out = jdm.forward(mcfg, p, jb, *batch[:3], stepsize=1.0, bg=0.0,
                              is_train=True, ndc_planes=True)
            return jt.losses.encoder_losses(out, batch[3], j.fine_train,
                                            96)[0]
        g = jax.grad(loss)(p)
        for name, fn, w in (("density", jdm.density_tv_grad, 1e-2),
                            ("k0", jdm.k0_tv_grad, 1e-3)):
            g[name] = jax.tree.map(jnp.add, g[name],
                                   fn(mcfg, p, w, True, 96, g[name]))
        return g

    want = _flat(jgrads(jp))
    tcfg = tdm.make_config(**jdm.get_kwargs(mcfg))
    step = tt.TrainStep(tdm, tcfg, t.fine_train, render_kwargs=rk)
    tp, tb = _t(params), _t(buffers)
    _, _, tg = step.loss_and_grads(
        tp, tb, tuple(torch.as_tensor(np.asarray(a)) for a in batch),
        ("density", "k0", "rgbnet"))
    step.add_tv(tp, tg, 96, True)
    for k, got in _flat(tg).items():
        np.testing.assert_allclose(got, want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_training_with_tensorf_grids_matches_jax(tmp_path):
    """The fern pretrain config on the tiny scene with both grids TensoRF:
    10 steps through the pg_scale boundary at 5 (the factors resized, the
    optimizer reset) from one initial checkpoint, TV off (the JAX step
    cannot add it on factors: the test above); then the port's last
    checkpoint round-trips through the JAX package's loader, factors and
    moments."""
    j, t = _tiny_cfgs(tmp_path, weight_tv_density=0.0, weight_tv_k0=0.0)
    data = tiny_scene.scene()
    xyz = jt.compute_bbox_by_cam_frustrm(
        j, data["HW"], data["Ks"], data["poses"], data["i_train"], 0.0, 1.0)
    kw = dict(j.fine_model_and_render)
    n = int(kw.pop("num_voxels") / 2 ** len(j.fine_train.pg_scale))
    mcfg = jt._make_cfg(jdm, j, *xyz, n, kw)
    params, buffers = _init_params(jdm, mcfg, 2)
    init = str(tmp_path / "init.npz")
    jc.save_checkpoint(init, jdm.get_kwargs(mcfg), params, buffers)
    args = types.SimpleNamespace(seed=0, no_reload=False,
                                 no_reload_optimizer=False, ft_path=init,
                                 i_print=1, i_val=0, i_weights=0)
    jw, tw = _Recorder(), _Recorder()
    _, jcfg, jp, jb = jt.scene_rep_reconstruction(
        args, j, j.fine_model_and_render, j.fine_train, *xyz, data,
        stage="fine", writer=jw)
    _, tcfg, tp, tb = tt.scene_rep_reconstruction(
        args, t, t.fine_model_and_render, t.fine_train, *xyz, data,
        stage="fine", writer=tw, device="cpu")
    assert tcfg.world_size == jcfg.world_size and len(tw.losses()) == 10
    np.testing.assert_allclose(tw.losses(), jw.losses(), rtol=1e-4)
    # what the factors render (entry by entry they differ: the docstring)
    np.testing.assert_array_equal(tb["mask_cache"].numpy(),
                                  np.asarray(jb["mask_cache"]))
    ro, rd, vd = (torch.as_tensor(a) for a in _rays(0, 256, True))
    outs = [tdm.forward(tcfg, p, tb, ro, rd, vd, stepsize=1.0,
                        ndc_planes=True)["rgb_marched"]
            for p in (tp, _t(_np(jp)))]
    diff = (outs[0] - outs[1]).abs()
    assert float(diff.max()) < 1e-2 and float(diff.mean()) < 5e-4
    assert tuple(tp["k0"]["xy_plane"].shape[:2]) == tcfg.world_size[:2]
    # the port's file in the JAX layout, read by the JAX loader and back
    last = str(tmp_path / "torch" / "tiny" / "fine_last.npz")
    _, p, b, o, step, _ = jc.load_checkpoint(last)
    assert step == 10 and set(_flat(p)) == set(_flat(tp))
    assert set(_flat(o["exp_avg"])) == set(_flat(tp))
    _, p2, _, o2, _, _ = tc.load_checkpoint(last, device="cpu")
    for k, v in _flat(p).items():
        np.testing.assert_array_equal(_flat(p2)[k], v, err_msg=k)
    for k, v in _flat(o["exp_avg_sq"]).items():
        np.testing.assert_array_equal(_flat(o2["exp_avg_sq"])[k], v)


def test_tensorf_mpi_model_renders_through_the_chunked_forward():
    """A TensoRF DirectMPIGO has no render route in the JAX package: its
    ``render_viewpoints`` takes the plane sweep whenever the planes align,
    and both sweeps read ``params["density"]`` as an array. The port sends
    it to the chunked forward, which the JAX package's own forward
    matches."""
    jmod, tmod, kw, _, _ = _model("dmpigo")
    jcfg, tcfg = jmod.make_config(**kw), tmod.make_config(**kw)
    params, buffers = _init_params(jmod, jcfg, 4)
    data = tiny_scene.scene()
    poses, HW, Ks = data["poses"][:1], data["HW"][:1], data["Ks"][:1]
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "stepsize": 1.0}
    assert jdm.plane_aligned_ok(jcfg, 1.0, True)
    with pytest.raises((AttributeError, TypeError)):
        jt.render_viewpoints(
            jdm, jcfg, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, buffers), poses, HW, Ks,
            cfg=jconfig.ConfigDict(dict(data=dict(
                ndc=True, inverse_y=False, flip_x=False, flip_y=False))),
            render_kwargs=rk, gt_imgs=[data["images"][0]], verbose=False)
    tp, tb = _t(params), _t(buffers)
    flags = tt.DataFlags(ndc=True)
    assert tt.frame_path(tdm, tcfg, tp, tb, flags, 1.0) == "chunked"
    with pytest.raises(ValueError, match="dense"):  # the frame's kernels
        pipeline.FramePipeline(tcfg, tp, tb, None, device="cpu")
    res = tt.render_viewpoints(tdm, tcfg, tp, tb, poses, HW, Ks, data=flags,
                               render_kwargs=rk, device="cpu", verbose=False)
    assert res["path"] == "chunked"
    ro, rd, vd = (np.asarray(a).reshape(-1, 3) for a in
                  jrays.get_rays_of_a_view(
                      24, 32, Ks[0], poses[0], ndc=True, inverse_y=False,
                      flip_x=False, flip_y=False))
    jout = jax.jit(lambda p, b: jmod.forward(
        jcfg, p, b, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd),
        stepsize=1.0, ndc_planes=True))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, buffers)))
    _close(res["rgbs"][0].reshape(-1, 3), jout["rgb_marched"], 1e-5, "frame")
