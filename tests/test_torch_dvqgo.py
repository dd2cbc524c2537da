"""Port parity of DirectQVGO (``models/dvqgo.py``) and its EMA codebook
(``ops/vq.py``) against the JAX package, float32 on the CPU, params drawn
with numpy (or by the JAX init) and handed to both.

Tolerances: the quantiser's indices are equal (no near-tie in these
draws); its outputs and the straight-through gradients 1e-6; the EMA
state 1e-6 relative (the port sums the rows into their codes by
``index_add_``, not by the one-hot product: another order of float32
additions; a code that no row chose yet has a Laplace-smoothed size near
0, so its entries reach 1e5 and only a relative bound means anything). The
model's forward 1e-5 (as the dense-grid parity tests'). The JAX package's
DirectQVGO training run (``tests/test_dvqgo_train.py``: 6 steps, no
``pg_scale``) reproduced from one initial checkpoint: per-step losses 1e-4
relative (as ``test_torch_train``'s), the codebook state 1e-4 relative
(six EMA steps on params that MaskedAdam moved by rounding-sized
differences).
"""

import functools
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.models import dvqgo as jq
from fourk_nerf_tpu.ops import rays as jrays, vq as jvq
from fourk_nerf_tpu.train import checkpoints as jc, optim as jo, \
    trainer as jt
from fourk_nerf_torch import config as tconfig, run as trun, weights
from fourk_nerf_torch.models import dvqgo as tq, model_module
from fourk_nerf_torch.ops import vq as tvq
from fourk_nerf_torch.train import checkpoints as tc, optim as to, \
    trainer as tt
from test_sr_trainer_ndc import _ndc_data

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "llff", "fern_lg_pretrain.py")
MODEL = dict(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
             num_voxels=16 * 16 * 8, mpi_depth=8, rgbnet_dim=6,
             rgbnet_width=16, spatial_pe=1, viewbase_pe=2,
             fast_color_thres=1.0 / 40, n_cluster=64, mode_type="adain_vq")


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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


def _close(got, want, atol, what="", rtol=0.0):
    want = _flat(want)
    got = _flat(got)
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what}/{k}")


def _vq_inputs(seed=0, n=300, input_dim=9, dim=6, n_embed=32):
    rng = np.random.default_rng(seed)
    params = {"project": {
        "w0": rng.normal(0, 0.5, (input_dim, dim)).astype(np.float32),
        "b0": rng.normal(0, 0.1, dim).astype(np.float32),
        "w1": rng.normal(0, 0.5, (dim, dim)).astype(np.float32),
        "b1": rng.normal(0, 0.1, dim).astype(np.float32)}}
    embed = rng.normal(0, 0.5, (dim, n_embed)).astype(np.float32)
    state = {"embed": embed,
             "cluster_size": rng.uniform(0, 3, n_embed).astype(np.float32),
             "embed_avg": embed * 1.5}
    x = rng.normal(0, 1, (n // 3, 3, input_dim)).astype(np.float32)
    return params, state, x


@pytest.mark.parametrize("training", [True, False])
def test_vq_forward_matches_jax(training):
    params, state, x = _vq_inputs()
    r = np.random.default_rng(5).normal(size=(*x.shape[:-1], 6)).astype(
        np.float32)

    @jax.jit
    def ref(p, s, x):
        def f(p):
            q, diff, idx, ns = jvq.vq_forward(p, s, x, training=training)
            return jnp.sum(q * r), (q, diff, idx, ns)
        return jax.value_and_grad(f, has_aux=True)(p)

    (_, (jq_, jdiff, jidx, jns)), jg = ref(
        *(jax.tree.map(jnp.asarray, t) for t in (params, state, x)))
    tp = {"project": {k: torch.as_tensor(v).requires_grad_(True)
                      for k, v in params["project"].items()}}
    q, diff, idx, ns = tvq.vq_forward(tp, weights.to_torch(state, "cpu"),
                                      torch.as_tensor(x), training=training)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(np.asarray(jidx))) > 10  # many codes in use
    _close(q, jq_, 1e-6, "quantize")
    np.testing.assert_allclose(diff.item(), float(jdiff), rtol=1e-6)
    _close(ns, jns, 1e-6, "state", rtol=1e-6)
    if not training:
        assert ns["embed"] is not None and np.array_equal(
            ns["embed"].numpy(), state["embed"])
    # the straight-through gradient reaches the projection as if q were v
    tg = torch.autograd.grad((q * torch.as_tensor(r)).sum(),
                             list(tp["project"].values()))
    _close(dict(zip(tp["project"], tg)), jg["project"], 1e-5, "grad")


def test_nearest_code_chunks_and_ties(monkeypatch):
    rng = np.random.default_rng(1)
    embed = rng.normal(size=(4, 16)).astype(np.float32)
    embed[:, 9] = embed[:, 3]  # a duplicate code: a tie at every row
    flat = np.concatenate([embed.T[[3, 9, 0]],
                           rng.normal(size=(200, 4)).astype(np.float32)])
    want = np.asarray(jnp.argmin(
        jnp.sum(flat ** 2, 1, keepdims=True) - 2.0 * flat @ embed
        + jnp.sum(embed ** 2, 0, keepdims=True), axis=1))
    got = tvq.nearest_code(torch.as_tensor(flat), torch.as_tensor(embed))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == got[1] == 3  # the first of the tied codes
    monkeypatch.setattr(tvq, "ROW_CHUNK", 7)
    np.testing.assert_array_equal(
        tvq.nearest_code(torch.as_tensor(flat),
                         torch.as_tensor(embed)).numpy(), want)


def _model(seed=0):
    jcfg = jq.make_config(**MODEL)
    params, buffers = jq.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params, buffers = _np(params), _np(buffers)
    params["density"] = rng.normal(-1, 2, params["density"].shape).astype(
        np.float32)
    return jcfg, params, buffers


def test_config_init_and_forward_match_jax():
    jcfg, params, buffers = _model()
    tcfg = tq.make_config(**MODEL)
    assert tq.get_kwargs(tcfg) == jq.get_kwargs(jcfg)
    assert tq.make_config(**tq.get_kwargs(tcfg)) == tcfg
    assert (tcfg.pe_dim, tcfg.n_cluster) == (jcfg.pe_dim, 64)
    tp0, tb0 = tq.init(tcfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert {k: v.shape for k, v in _flat(tp0).items()} == \
        {k: v.shape for k, v in _flat(params).items()}
    assert {k: v.shape for k, v in _flat(tb0).items()} == \
        {k: v.shape for k, v in _flat(buffers).items()}
    assert float(tp0["k0_vq"]["project"]["b1"].abs().sum()) > 0  # drawn
    K = np.array([[6.0, 0, 4.0], [0, 6.0, 3.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    rays = [np.asarray(a).reshape(-1, 3) for a in jrays.get_rays_of_a_view(
        6, 8, K, c2w, ndc=True, inverse_y=False, flip_x=False, flip_y=False)]
    noise = np.random.default_rng(2).uniform(size=(48, 3)).astype(np.float32)
    tp, tb = weights.dvqgo_from_numpy(params, buffers, device="cpu")
    for is_train in (False, True):
        jout = jax.jit(functools.partial(
            jq.forward, jcfg, stepsize=1.0, bg=0.5, render_depth=True,
            is_train=is_train))(*(jax.tree.map(jnp.asarray, t) for t in
                                  (params, buffers)),
                                *(jnp.asarray(a) for a in rays))
        tout = tq.forward(tcfg, tp, tb, *(torch.as_tensor(a) for a in rays),
                          stepsize=1.0, bg=0.5, render_depth=True,
                          is_train=is_train, bg_noise=torch.as_tensor(noise))
        for k in ("rgb_marched", "rgb_feature", "alphainv_last", "depth",
                  "weights", "raw_alpha", "vq_diff"):
            np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), atol=1e-5,
                                       err_msg=k)
        assert ("vq_state" in tout) == ("vq_state" in jout) == is_train
    _close(tout["vq_state"], jout["vq_state"], 1e-6, "vq_state", rtol=1e-6)
    assert float(tout["weights"].sum()) > 0.1


def test_build_group_lrs_maps_lrate_k0_to_the_codebook():
    _, params, _ = _model()
    cfg_train = jconfig.ConfigDict(dict(lrate_density=0.1, lrate_k0=0.2,
                                        lrate_rgbnet=1e-3, lrate_srnet=0,
                                        N_iters=5))
    want = jo.build_group_lrs(cfg_train, params)
    assert want == {"density": 0.1, "k0_vq": 0.2, "rgbnet": 1e-3}
    assert to.build_group_lrs(cfg_train, params) == want
    # a DirectMPIGO keeps k0
    assert to.build_group_lrs(cfg_train, {"k0": 0, "k0_vq": 0}) == {"k0": 0.2}


def test_checkpoints_round_trip_in_both_directions(tmp_path):
    jcfg, params, buffers = _model(1)
    opt = _np(jo.init_state(jax.tree.map(jnp.asarray, params)))
    opt["exp_avg"] = jax.tree.map(lambda a: a + 0.5, opt["exp_avg"])
    a, b, c = (str(tmp_path / n) for n in ("jax.npz", "port.npz", "j2.npz"))
    jc.save_checkpoint(a, jq.get_kwargs(jcfg), params, buffers, opt, 7)
    kw, tp, tb, topt, step, _ = tc.load_checkpoint(a, device="cpu")
    assert step == 7 and topt["step"] == 0
    assert tq.make_config(**kw) == tq.make_config(**MODEL)
    _close(tp, params, 0, "params")
    _close(tb, buffers, 0, "buffers")
    assert tb["mask_cache"].dtype == torch.bool
    tc.save_checkpoint(b, kw, tp, tb, topt, step)
    kw2, p2, b2, o2, step2, _ = jc.load_checkpoint(b)
    assert kw2 == kw and step2 == 7 and int(o2["step"]) == 0
    for got, want in ((p2, params), (b2, buffers),
                      (o2["exp_avg"], opt["exp_avg"])):
        _close(got, want, 0)
    assert set(_flat(tp)) >= {"k0_vq/project/w0", "density"} and \
        "vq_state/embed" in _flat(tb)


def _vq_cfgs(tmp_path, **fine_train):
    """The JAX package's ``test_dvqgo_train`` configuration, for both."""
    out = []
    for pkg, load in (("jax", jconfig.load_config),
                      ("torch", tconfig.load_config)):
        cfg = load(os.path.join(ROOT, "fourk_nerf_tpu" if pkg == "jax"
                                else "fourk_nerf_torch", CFG))
        cfg.basedir, cfg.expname = str(tmp_path / pkg), "vq_smoke"
        cfg.data.ndc, cfg.data.rand_bkgd = True, False
        cfg.coarse_train.N_iters = 0
        for k, v in {**dict(N_iters=6, N_rand=128, pg_scale=[],
                            ray_sampler="flatten"), **fine_train}.items():
            cfg.fine_train[k] = v
        for k, v in dict(mode_type="adain_vq", num_voxels=32 * 32 * 8,
                         mpi_depth=8, rgbnet_dim=6, rgbnet_width=16,
                         n_cluster=64, stepsize=1.0).items():
            cfg.fine_model_and_render[k] = v
        out.append(cfg)
    return out


def _args(**kw):
    return types.SimpleNamespace(**{**dict(
        seed=0, no_reload=False, no_reload_optimizer=False, ft_path="",
        i_print=1, i_val=0, i_weights=0), **kw})


class _Recorder:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def losses(self):
        return [v for tag, v, _ in self.rows if tag == "train/loss"]


def test_training_run_matches_jax(tmp_path, monkeypatch):
    """``tests/test_dvqgo_train.py``'s run (6 steps, no pg_scale) in both
    packages from one initial checkpoint: the same losses, the same
    codebook; then ``run --render_only`` reloads the port's last file as a
    DirectQVGO and renders the test views through the chunked forward."""
    j, t = _vq_cfgs(tmp_path)
    dd = _ndc_data()
    xyz = jt.compute_bbox_by_cam_frustrm(
        j, dd["HW"], dd["Ks"], dd["poses"], dd["i_train"], dd["near"],
        dd["far"])
    kw = dict(j.fine_model_and_render)
    mcfg = jt._make_cfg(jq, j, *xyz, kw.pop("num_voxels"), kw)
    params, buffers = jq.init(mcfg, jax.random.PRNGKey(3))
    params, buffers = _np(params), _np(buffers)
    params["density"] = np.random.default_rng(3).normal(
        0, 1, params["density"].shape).astype(np.float32)
    init = str(tmp_path / "init.npz")
    jc.save_checkpoint(init, jq.get_kwargs(mcfg), params, buffers)
    jw, tw = _Recorder(), _Recorder()
    jmod, _, jp, jb = jt.scene_rep_reconstruction(
        _args(ft_path=init), j, j.fine_model_and_render, j.fine_train, *xyz,
        dd, stage="fine", writer=jw)
    tmod, tcfg, tp, tb = tt.scene_rep_reconstruction(
        _args(ft_path=init), t, t.fine_model_and_render, t.fine_train, *xyz,
        dd, stage="fine", writer=tw, device="cpu")
    assert jmod is jq and tmod is tq and tt.select_model_mod(t) is tq
    assert len(tw.losses()) == 6
    np.testing.assert_allclose(tw.losses(), jw.losses(), rtol=1e-4)
    _close(tb["vq_state"], jb["vq_state"], 1e-6, "vq_state", rtol=1e-4)
    # the EMA learned: sizes accumulated, the codebook moved
    assert float(tb["vq_state"]["cluster_size"].sum()) > 0
    assert not np.allclose(tb["vq_state"]["embed"].numpy(),
                           buffers["vq_state"]["embed"])
    # --render_only: the checkpoint is a DirectQVGO's, rendered chunked
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    args = trun.config_parser().parse_args(
        ["--config", "x", "--render_only", "--render_test", "--device",
         "cpu"])
    res = trun.run(args, t, dd)["test"]
    assert res["path"] == "chunked" and len(res["psnrs"]) == len(dd["i_test"])
    ref = tt.render_viewpoints(
        tq, tcfg, tp, tb, dd["poses"][dd["i_test"]], dd["HW"][dd["i_test"]],
        dd["Ks"][dd["i_test"]], data=tt.DataFlags(ndc=True),
        render_kwargs={"stepsize": 1.0, "bg": 0.0}, device="cpu")
    assert torch.equal(res["rgbs"], ref["rgbs"])


def test_pg_scale_is_refused_up_front(tmp_path):
    """The JAX package's DirectQVGO has no ``scale_volume_grid``: its loop
    stops with an AttributeError at the first pg_scale step. The port
    refuses such a run before it trains or writes anything."""
    assert not hasattr(jq, "scale_volume_grid")
    j, t = _vq_cfgs(tmp_path, pg_scale=[1], N_iters=2)
    dd = _ndc_data(n_views=2)
    xyz = jt.compute_bbox_by_cam_frustrm(
        j, dd["HW"], dd["Ks"], dd["poses"], dd["i_train"], dd["near"],
        dd["far"])
    with pytest.raises(AttributeError, match="scale_volume_grid"):
        jt.scene_rep_reconstruction(_args(no_reload=True), j,
                                    j.fine_model_and_render, j.fine_train,
                                    *xyz, dd, stage="fine")
    with pytest.raises(ValueError, match="scale_volume_grid"):
        tt.scene_rep_reconstruction(_args(no_reload=True), t,
                                    t.fine_model_and_render, t.fine_train,
                                    *xyz, dd, stage="fine", device="cpu")
    with pytest.raises(ValueError, match="pg_scale"):
        tt.train(_args(no_reload=True), t, dd, device="cpu")
    assert not (tmp_path / "torch" / "vq_smoke").exists() or not any(
        (tmp_path / "torch" / "vq_smoke").glob("*.npz"))
    assert model_module(True, False, "adain_vq") is tq
