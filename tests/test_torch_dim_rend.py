"""Port parity of DirectMPIGO with ``dim_rend > 3`` (its ``rend_layer``)
against the JAX package's ``models/dmpigo.py``: the init's layout and
draw order, the forward (the rgbnet under leaky ReLU, the
``dim_rend``-channel composite, the rend layer on the marched features and
on each sample's raw colour), its gradients, training steps from one
checkpoint with the layer frozen (no ``lrate_rend_layer``, as in the JAX
package) and trained, and the render route: the JAX package's plane sweep
fails on such a model, the port renders it through the chunked forward.

Tolerances: forward values 1e-5; gradients within 1e-5 of each leaf's
largest entry; per-step losses of the 10-step runs 1e-4 relative and the
trained rend layer 1e-4 (as ``test_torch_train.py``); a frozen layer
bitwise unchanged; the chunked frame 1e-5 of the JAX forward on the same
rays."""

import inspect
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import dmpigo as jd
from fourk_nerf_tpu.ops import plane_sweep as jps
from fourk_nerf_tpu.train import sr_trainer as jsr, trainer as jt
from fourk_nerf_torch import pipeline, weights
from fourk_nerf_torch.models import common as tcommon, dmpigo as td, \
    sr_esrnet
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import sr_trainer as tsr, trainer as tt

from test_torch_dmpigo_train import _rays
from test_torch_train import Recorder, _args, _cfgs, _flat, _init_checkpoint

CFG_KW = dict(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
              num_voxels=16 * 16 * 8, mpi_depth=8, fast_color_thres=1.0 / 40,
              rgbnet_dim=6, rgbnet_width=16, viewbase_pe=2, spatial_pe=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(dim_rend, seed=0):
    """JAX and port configs, and the JAX init's params with numpy-drawn
    grids, rgbnet and rend layer."""
    kw = {**CFG_KW, "dim_rend": dim_rend}
    jcfg = jd.make_config(**kw)
    params, buffers = jd.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: rng.normal(0, 0.7, a.shape).astype(
        np.float32), params)
    params["density"] = rng.normal(-1, 2, params["density"].shape).astype(
        np.float32)
    buffers = {"act_shift": np.asarray(buffers["act_shift"]),
               "mask_cache": rng.uniform(size=jcfg.mask_cache_world_size)
               < 0.8}
    return jcfg, td.make_config(**kw), params, buffers


@pytest.mark.parametrize("dim_rend", [6, 8])
def test_init_layout_matches_jax(dim_rend):
    jcfg, tcfg, _, _ = _scene(dim_rend)
    jp, _ = jd.init(jcfg, jax.random.PRNGKey(0))
    tp, _ = td.init(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert {k: v.shape for k, v in _flat(tp).items()} == \
        {k: v.shape for k, v in _flat(jp).items()}
    assert tp["rgbnet"]["w2"].shape == (16, dim_rend)
    assert tp["rend_layer"]["w0"].shape == (dim_rend, 3)
    assert not bool(tp["rend_layer"]["b0"].any())  # final bias zero
    # drawn after the grids and the rgbnet from the same generator
    g = torch.Generator().manual_seed(0)
    for name, ch in (("density", 1), ("k0", tcfg.k0_dim)):
        tcommon.grid_init(tcfg.density_type, ch, tcfg.world_size,
                          generator=g, device="cpu")
    tcommon.mlp_init([tcfg.dim0, 16, 16, dim_rend], generator=g,
                     device="cpu")
    want = tcommon.mlp_init([dim_rend, 3], generator=g, device="cpu")
    assert torch.equal(tp["rend_layer"]["w0"], want["w0"])
    assert td.get_kwargs(tcfg) == jd.get_kwargs(jcfg)


@pytest.mark.parametrize("dim_rend,ndc_planes", [(6, True), (8, False)])
def test_forward_and_gradients_match_jax(dim_rend, ndc_planes):
    jcfg, tcfg, params, buffers = _scene(dim_rend)
    ro, rd, vd = _rays()
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.uniform(key, (ro.shape[0], 3)))
    target = np.random.default_rng(1).uniform(size=(ro.shape[0], 3)).astype(
        np.float32)
    kw = dict(stepsize=1.0, bg=0.0, rand_bkgd=True, is_train=True,
              ndc_planes=ndc_planes, render_depth=True)

    def jloss(p):
        out = jd.forward(jcfg, p, jax.tree.map(jnp.asarray, buffers),
                         *(jnp.asarray(a) for a in (ro, rd, vd)), key=key,
                         **kw)
        loss = jnp.mean((out["rgb_marched"] - target) ** 2) + jnp.mean(
            out["rgb_feature"] ** 2) + jnp.mean(out["raw_rgb"])
        return loss, out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    tout = td.forward(tcfg, tp, tb, *(torch.as_tensor(a) for a in (ro, rd,
                                                                    vd)),
                      bg_noise=torch.as_tensor(noise), **kw)
    tl = ((tout["rgb_marched"] - torch.as_tensor(target)) ** 2).mean() + (
        tout["rgb_feature"] ** 2).mean() + tout["raw_rgb"].mean()
    assert tout["rgb_feature"].shape == (ro.shape[0], dim_rend)
    assert tout["rgb_marched"].shape == (ro.shape[0], 3)
    for k in ("rgb_marched", "rgb_feature", "raw_rgb", "weights",
              "alphainv_last", "depth"):
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    grads = dict(zip(_flat(tp), torch.autograd.grad(
        tl, [v for v in jax.tree.leaves(tp)])))
    for k, want in _flat(jg).items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
        assert np.abs(want).max() > 0, k


@pytest.mark.parametrize("lrate_rend_layer", [0.0, 1e-2])
def test_training_steps_match_jax(tmp_path, lrate_rend_layer):
    """10 steps of the tiny fern cut with ``dim_rend`` 8 from one JAX
    checkpoint (through the pg_scale step at 5): the same losses; the rend
    layer frozen bitwise without ``lrate_rend_layer`` (in both packages)
    and trained alike with it."""
    jcfg_all, tcfg_all = _cfgs(tmp_path)
    for c in (jcfg_all, tcfg_all):
        c.fine_model_and_render.dim_rend = 8
        if lrate_rend_layer:
            c.fine_train.lrate_rend_layer = lrate_rend_layer
    data = tiny_scene.scene()
    init = str(tmp_path / "init.npz")
    _, p0, _ = _init_checkpoint(jcfg_all, data, init)
    xyz = jt.compute_bbox_by_cam_frustrm(
        jcfg_all, data["HW"], data["Ks"], data["poses"], data["i_train"],
        0.0, 1.0)
    jw, tw = Recorder(), Recorder()
    _, _, jp, _ = jt.scene_rep_reconstruction(
        _args(ft_path=init), jcfg_all, jcfg_all.fine_model_and_render,
        jcfg_all.fine_train, *xyz, data, stage="fine", writer=jw)
    _, _, tp, _ = tt.scene_rep_reconstruction(
        _args(ft_path=init), tcfg_all, tcfg_all.fine_model_and_render,
        tcfg_all.fine_train, *xyz, data, stage="fine", writer=tw,
        device="cpu")
    assert len(tw.losses()) == len(jw.losses()) == 10
    np.testing.assert_allclose(tw.losses(), jw.losses(), rtol=1e-4)
    got, want = _flat(tp["rend_layer"]), _flat(jp["rend_layer"])
    for k, w0 in p0["rend_layer"].items():
        if lrate_rend_layer:
            assert np.abs(got[k] - w0).max() > 1e-3, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w0, err_msg=k)
            np.testing.assert_array_equal(want[k], w0, err_msg=k)


def test_render_route_is_chunked_where_the_jax_sweep_fails():
    jcfg, tcfg, params, buffers = _scene(8)
    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    flags = tt.DataFlags(ndc=True)
    assert td.plane_aligned_ok(tcfg, 1.0, True)
    assert tt.frame_path(td, tcfg, tp, tb, flags, 1.0) == "chunked"
    tcfg3 = td.make_config(**{**CFG_KW, "dim_rend": 3})
    assert tt.frame_path(td, tcfg3, {**tp, "rgbnet": tp["rgbnet"]}, tb,
                         flags, 1.0) == "sweep"
    H, W = 6, 8
    f = W * 0.75
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = (0.0, 0.01, 1.0)
    # the JAX package's sweep composites 3 channels
    with pytest.raises(TypeError, match="incompatible shapes"):
        jps.render_frame(jcfg, jax.tree.map(jnp.asarray, params),
                         jax.tree.map(jnp.asarray, buffers), H, W, K, c2w,
                         stepsize=1.0, bg=0.0, tile=2, patch=12)
    res = tt.render_viewpoints(td, tcfg, tp, tb, c2w[None],
                               np.array([[H, W]]), K[None], data=flags,
                               render_kwargs={"stepsize": 1.0, "bg": 0.0},
                               device="cpu")
    assert res["path"] == "chunked"
    assert tuple(res["rgb_features"].shape) == (1, H, W, 8)
    ro, rd, vd = _rays(H, W)
    want = jd.forward(jcfg, jax.tree.map(jnp.asarray, params),
                      jax.tree.map(jnp.asarray, buffers), ro, rd, vd,
                      stepsize=1.0, bg=0.0, ndc_planes=True)
    np.testing.assert_allclose(res["rgbs"][0].reshape(-1, 3).numpy(),
                               np.asarray(want["rgb_marched"]), atol=1e-5)
    # the sweep kernel's frame refuses it up front
    sr = sr_esrnet.SFTNet(num_feat=8, num_block=1, num_grow_ch=4,
                          n_in_colors=8)
    with pytest.raises(ValueError, match="dim_rend"):
        pipeline.FramePipeline(tcfg, tp, tb, sr, device="cpu")


def test_joint_trainer_refuses_what_the_jax_one_cannot_train(tmp_path):
    """The JAX joint step takes the photometric L1 of the ``[N, dim_rend]``
    ``rgb_feature`` against the 3-channel target, which fails for
    ``dim_rend > 3``; the port's joint trainer and ``run_sr`` refuse such
    a config before any work."""
    src = inspect.getsource(jsr.make_sr_train_step)
    assert 'rgb_render = out["rgb_feature"]' in src
    assert "jnp.abs(rgb_render - target)" in src
    jcfg, _, params, buffers = _scene(8)
    ro, rd, vd = _rays()
    out = jd.forward(jcfg, jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, buffers), ro, rd, vd,
                     stepsize=1.0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jnp.abs(out["rgb_feature"] - jnp.zeros((ro.shape[0], 3)))
    from fourk_nerf_torch import config as tconfig, run_sr
    cfg = tconfig.load_config(os.path.join(
        os.path.dirname(__file__), "..", "fourk_nerf_torch", "configs",
        "llff", "fern_lg_joint_l1.py"))
    cfg.basedir = str(tmp_path)
    cfg.fine_model_and_render.dim_rend = 8
    with pytest.raises(ValueError, match="dim_rend"):
        tsr.train_sr(_args(), cfg, tiny_scene.sr_scene(), device="cpu")
    args = run_sr.config_parser().parse_args(
        ["--config", "c.py", "--device", "cpu"])
    with pytest.raises(ValueError, match="dim_rend"):
        run_sr.run(args, cfg, {})
    assert not any(tmp_path.iterdir())
