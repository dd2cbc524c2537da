"""Port parity of the ``patch_box`` path: the slab sweep's training form
(``box_sweep.sweep_rays_train_box``), its static plans, the ``patch_box``
sampler and the loop's per-view plans, against the JAX package's
(``ops/box_sweep.py``, ``train/trainer.py``), on the scene of the JAX
package's ``tests/test_box_train.py`` (a 40^3 DirectVoxGO blob, an
off-centre 8x8 patch) and on the tiny bounded scene.

Tolerances: the plans, windows, sampler draws and ``s`` equal; at
``use_bf16=False`` the outputs and weights 2e-6 of the JAX sweep's and,
as the JAX test holds its sweep to the gather forward, 2e-5 of
``dvgo.forward``, the loss 1e-5 relative and the gradients 5e-5; at
``use_bf16=True`` (the trainer's mode) the outputs 2e-6 of the JAX sweep's
(both round the same values to bf16; the sums run in another order) and
the loss and gradients within the bf16 rounding of the gather forward's
(loss 1e-3 relative, gradients 2% of each leaf's largest entry);
``raw_rgb`` compared where the weight is non-zero (the port leaves a
weight-0 slot's colour 0) 5e-6 (1e-5 at bf16: the MLP's sums in another
order). The training run: the loss at every step 2e-3
relative of the JAX run's (bf16 grid values and MLP; a value that rounds
the other way moves the step by ~1e-4, and MaskedAdam carries it on); the
resumed run replays the unbroken one bitwise. The training run's grid
(28^3) and patches (8x8) keep the JAX package's shared window within
every view's extents, where it would cap it (the port does not)."""

import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.config import ConfigDict as JConfigDict
from fourk_nerf_tpu.models import dvgo as jd
from fourk_nerf_tpu.ops import box_sweep as jb
from fourk_nerf_tpu.train import losses as jl, trainer as jt
from fourk_nerf_torch import config as tconfig, weights
from fourk_nerf_torch.config import ConfigDict
from fourk_nerf_torch.models import dvgo as td
from fourk_nerf_torch.ops import box_sweep as tb
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import losses as tl, trainer as tt

sys.path.insert(0, os.path.dirname(__file__))
from test_box_train import _scene  # noqa: E402  the JAX test's scene
from test_torch_bounded_train import _same_rgbnet  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KW = dict(stepsize=0.5, near=0.2, bg=1.0)
TRAIN = dict(weight_main=1.0, weight_entropy_last=1e-3,
             weight_distortion=0.01, weight_rgbper=0.01, weight_nearclip=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_scenes(native_mask=False):
    """The JAX scene and the port's copy of it: (jax, torch) of (cfg,
    params, buffers, rays_o, rays_d, viewdirs)."""
    cfg, params, buffers, ro, rd, vd = _scene()
    if native_mask:  # the JAX test's mask at another resolution
        rng = np.random.default_rng(11)
        buffers = {**buffers, "mask_cache": jnp.asarray(
            rng.uniform(size=(25, 27, 23)) < 0.6)}
    tcfg = td.make_config(**jd.get_kwargs(cfg))
    tp, tbuf = weights.dvgo_from_numpy(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, buffers),
                                       device="cpu")
    rays = [torch.as_tensor(np.array(a)) for a in (ro, rd, vd)]
    return (cfg, params, buffers, ro, rd, vd), (tcfg, tp, tbuf, *rays)


def _plan(j):
    cfg, _, _, ro, rd, vd = j
    axis, flip, S = jb.box_train_plan(cfg, ro, rd, stepsize=KW["stepsize"],
                                      near=KW["near"])
    Pu, Pv = jb.box_window_size_for(cfg, ro, rd, vd,
                                    stepsize=KW["stepsize"],
                                    near=KW["near"], axis=axis, flip=flip)
    return dict(axis=axis, flip=flip, S=S, Pu=Pu, Pv=Pv)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_plans_and_windows_match_jax():
    j, t = _both_scenes()
    cfg, tcfg = j[0], t[0]
    plan = _plan(j)
    assert tb.box_train_plan(tcfg, t[3], t[4], stepsize=KW["stepsize"],
                             near=KW["near"]) == (plan["axis"], plan["flip"],
                                                  plan["S"])
    assert tb.box_window_size_for(
        tcfg, t[3], t[4], t[5], stepsize=KW["stepsize"], near=KW["near"],
        axis=plan["axis"], flip=plan["flip"]) == (plan["Pu"], plan["Pv"])
    # another sweep direction than the view's plan, on its tiled patches
    data = tiny_scene.bounded_scene(h=32, w=32)
    for v in (2,):
        ro, rd, vd = (np.asarray(a) for a in jt.ray_ops.get_rays_of_a_view(
            32, 32, data["Ks"][v], data["poses"][v], ndc=False,
            inverse_y=False, flip_x=False, flip_y=False))
        jp = jb.box_train_plan(cfg, ro, rd, stepsize=0.5, near=2.0)
        tp = tb.box_train_plan(tcfg, torch.as_tensor(ro),
                               torch.as_tensor(rd), stepsize=0.5, near=2.0)
        assert tp == jp
        tiles = lambda x: x.reshape(2, 16, 2, 16, 3).transpose(
            0, 2, 1, 3, 4).reshape(4, 256, 3)
        for axis, flip in (((jp[0] + 1) % 3, not jp[1]),):
            want = jb.box_window_size_for(
                cfg, tiles(ro), tiles(rd), tiles(vd), stepsize=0.5, near=2.0,
                axis=axis, flip=flip, cap=1000)
            got = tb.box_window_size_for(
                tcfg, *(torch.as_tensor(tiles(a)) for a in (ro, rd, vd)),
                stepsize=0.5, near=2.0, axis=axis, flip=flip, cap=1000)
            assert got == want, (v, axis, flip)
    assert tb._mask_plane_plan(40, 23)[1] == jb._mask_plane_plan(40, 23)[1]
    np.testing.assert_array_equal(tb._mask_plane_plan(40, 23)[0],
                                  jb._mask_plane_plan(40, 23)[0])


@pytest.mark.parametrize("use_bf16,native_mask", [
    (False, False), (True, False), (False, True), (True, True)])
def test_sweep_outputs_match_jax(use_bf16, native_mask):
    j, t = _both_scenes(native_mask)
    plan = _plan(j)
    want = jb.sweep_rays_train_box(*j, **KW, **plan, use_bf16=use_bf16)
    got = tb.sweep_rays_train_box(*t, **KW, **plan, use_bf16=use_bf16)
    for k in ("rgb_marched", "rgb_feature", "alphainv_last", "weights",
              "depth"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=0,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(_np(got["s"]), _np(want["s"]))
    assert got["n_max"] == want["n_max"]
    w = _np(want["weights"])
    m = w > 0
    assert m.sum() > 100
    np.testing.assert_array_equal(_np(got["weights"]) > 0, m)
    np.testing.assert_allclose(_np(got["raw_rgb"])[m],
                               np.asarray(want["raw_rgb"])[m], rtol=0,
                               atol=5e-6 if not use_bf16 else 1e-5)


@pytest.mark.parametrize("native_mask", [False, True])
def test_sweep_matches_the_gather_forward(native_mask):
    """As the JAX test holds its sweep: the composite and the weights,
    scattered back onto the global sample index, against ``dvgo.forward``
    on the same rays."""
    _, t = _both_scenes(native_mask)
    tcfg, tp, tbuf, ro, rd, vd = t
    plan = _plan(_both_scenes(native_mask)[0])
    ref = td.forward(tcfg, tp, tbuf, ro, rd, vd, stepsize=KW["stepsize"],
                     near=KW["near"], far=1e9, bg=KW["bg"], is_train=True)
    got = tb.sweep_rays_train_box(*t, **KW, **plan, use_bf16=False)
    for k in ("rgb_marched", "alphainv_last"):
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), atol=2e-5,
                                   err_msg=k)
    k_idx = np.rint(_np(got["s"]) * ref["n_max"] - 0.5).astype(np.int64)
    w_got = _np(got["weights"])
    dense = np.zeros(tuple(ref["weights"].shape))
    rows, cols = np.nonzero(w_got > 0)
    assert len(set(zip(rows, k_idx[rows, cols]))) == len(rows)
    dense[rows, k_idx[rows, cols]] = w_got[rows, cols]
    np.testing.assert_allclose(dense, _np(ref["weights"]), atol=2e-5)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_loss_and_gradients_match_the_gather_forward(use_bf16):
    j, t = _both_scenes()
    plan = _plan(j)
    tcfg, tp, tbuf, ro, rd, vd = t
    target = torch.as_tensor(np.random.default_rng(9).uniform(
        0, 1, (ro.shape[0], 3)).astype(np.float32))
    train = ConfigDict(TRAIN)

    def loss_grads(fwd):
        p = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in tp.items()}
        out = fwd(p)
        loss = tl.encoder_losses(out, target, train, ro.shape[0])[0]
        leaves = [p["density"], p["k0"], *p["rgbnet"].values()]
        return float(loss), torch.autograd.grad(loss, leaves)

    l_ref, g_ref = loss_grads(lambda p: td.forward(
        tcfg, p, tbuf, ro, rd, vd, stepsize=KW["stepsize"], near=KW["near"],
        far=1e9, bg=KW["bg"], is_train=True))
    l_box, g_box = loss_grads(lambda p: tb.sweep_rays_train_box(
        tcfg, p, tbuf, ro, rd, vd, **KW, **plan, use_bf16=use_bf16))
    if not use_bf16:
        np.testing.assert_allclose(l_box, l_ref, rtol=1e-5)
        for a, b in zip(g_ref, g_box):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)
    else:
        np.testing.assert_allclose(l_box, l_ref, rtol=1e-3)
        for a, b in zip(g_ref, g_box):
            scale = float(a.abs().max())
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=0.02 * scale)
    # and the JAX sweep's loss at the same rounding
    jcfg, jp, jbuf, jro, jrd, jvd = j
    jout = jb.sweep_rays_train_box(jcfg, jp, jbuf, jro, jrd, jvd, **KW,
                                   **plan, use_bf16=use_bf16)
    j_loss = float(jl.encoder_losses(jout, jnp.asarray(target.numpy()),
                                     JConfigDict(TRAIN), ro.shape[0])[0])
    np.testing.assert_allclose(l_box, j_loss, rtol=1e-5)


def test_a_window_wider_than_the_sweep_reads_the_grid_whole():
    """The stage's window serves views that sweep other axes; where it is
    wider than this sweep's extents (48 > 40) the port reads the grid whole
    and still equals the gather forward (the JAX package caps the window
    at the narrowest extent instead, ``trainer.compute_box_plans``)."""
    j, t = _both_scenes()
    plan = {**_plan(j), "Pu": 48, "Pv": 48}
    tcfg, tp, tbuf, ro, rd, vd = t
    ref = td.forward(tcfg, tp, tbuf, ro, rd, vd, stepsize=KW["stepsize"],
                     near=KW["near"], far=1e9, bg=KW["bg"], is_train=True)
    got = tb.sweep_rays_train_box(*t, **KW, **plan, use_bf16=False)
    assert max(tcfg.world_size) < 48
    for k in ("rgb_marched", "alphainv_last"):
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), atol=2e-5,
                                   err_msg=k)


def test_patch_box_sampler_matches_jax():
    for V, H, W, n_rand in ((3, 40, 40, 256), (2, 40, 36, 8192 // 64),
                            (2, 100, 120, 8192)):
        want = jt.make_batch_sampler("patch_box", {"rgb": np.zeros(
            (V, H, W, 3), np.float32)}, n_rand, 5)
        got = tt.make_batch_sampler("patch_box", {"rgb": torch.zeros(
            (V, H, W, 3))}, n_rand, 5)
        assert got.patch == want.patch
        n = 3 * V * len({min(r, H - got.patch) for r in range(0, H,
                                                                  got.patch)})
        # replayed out of order: a pure function of (seed, step)
        seq = [got(i) for i in reversed(range(n))][::-1]
        assert seq == [want(i) for i in range(n)]
    assert tt.make_batch_sampler("patch_box", {"rgb": torch.zeros(
        (1, 800, 800, 3))}, 8192, 0).patch == 88


def _run_cfg(pkg, cm, basedir, n_iters):
    cfg = cm.load_config(os.path.join(ROOT, pkg, "configs", "syn",
                                      "syn_default.py"))
    cfg.basedir, cfg.expname = basedir, "pb"
    over = tiny_scene.BOUNDED_OVERRIDES
    for sec in ("coarse_model_and_render", "fine_model_and_render"):
        for k, v in over[sec].items():
            cfg[sec][k] = v
    # a grid wide enough that the JAX package's shared window (at least 16
    # voxels) is not capped by a view's minor extents, which the port
    # does not do (``trainer.compute_box_plans``)
    cfg.fine_model_and_render.update(num_voxels=28 ** 3,
                                     num_voxels_base=28 ** 3)
    cfg.coarse_train.N_iters = 0
    cfg.fine_train.update(N_iters=n_iters, N_rand=64, pg_scale=[6],
                          ray_sampler="patch_box")
    return cfg


def _args(**kw):
    return types.SimpleNamespace(**{**dict(
        seed=777, no_reload=False, no_reload_optimizer=False, ft_path="",
        i_print=1, i_val=0, i_weights=0), **kw})


class _Rec:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        if tag == "train/loss":
            self.rows.append(float(value))


def _tiny_scene():
    return tiny_scene.bounded_scene(h=32, w=32, n_train=2, n_val=1,
                                    n_test=1)


def test_patch_box_run_matches_jax(tmp_path, monkeypatch, capsys):
    """8 steps of ``syn_default`` (the tiny cut at 28^3, no coarse stage)
    on 32x32 views with ``patch_box`` on 8x8 patches: the JAX trainer and the port take the
    slab sweep with the same plans and windows, before and after the
    ``pg_scale`` step, and the same losses."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _same_rgbnet(monkeypatch)
    data = _tiny_scene()
    runs = {}
    for pkg, cm, mod, kw in (
            ("fourk_nerf_tpu", jconfig, jt, {}),
            ("fourk_nerf_torch", tconfig, tt, {"device": "cpu"})):
        rec = _Rec()
        mod.train(_args(no_reload=True),
                  _run_cfg(pkg, cm, str(tmp_path / pkg), 8), data,
                  writer=rec, **kw)
        log = capsys.readouterr().out.splitlines()
        runs[pkg] = (np.array(rec.rows),
                     [line for line in log if "slab-sweep ON" in line], log)
    want, got = runs["fourk_nerf_tpu"], runs["fourk_nerf_torch"]
    assert len(got[1]) == 2 and got[1] == want[1]
    assert len(got[0]) == 8
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3)
    assert "scene_rep_reconstruction (fine): patch_box steps: 8 slab " \
        "sweep, 0 gather forward" in got[2]


def test_patch_box_resume_is_bit_exact(tmp_path, monkeypatch):
    """A run stopped at step 4 and resumed from its periodic file (before
    the pg_scale step at 6) ends where the unbroken run ends, bitwise."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = _tiny_scene()

    def run(name, n_iters):
        return tt.train(_args(i_weights=4), _run_cfg(
            "fourk_nerf_torch", tconfig, str(tmp_path / name), n_iters),
            data, device="cpu")

    *_, p_full, _ = run("a", 10)
    run("b", 4)
    *_, p_res, _ = run("b", 10)
    for k in ("density", "k0"):
        assert torch.equal(p_full[k], p_res[k]), k
    for k, v in p_full["rgbnet"].items():
        assert torch.equal(v, p_res["rgbnet"][k]), k


def test_other_models_take_the_gather_forward(tmp_path, monkeypatch,
                                              capsys):
    """A DirectContractedVoxGO stage with ``patch_box`` trains on the same
    patches through its gather forward (the JAX package's rule: the slab
    sweep serves DirectVoxGO), and says so."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = tconfig.load_config(os.path.join(ROOT, "fourk_nerf_torch",
                                           "configs", "syn",
                                           "syn_default.py"))
    cfg.basedir, cfg.expname = str(tmp_path), "unb"
    for over in (tiny_scene.UNBOUNDED_OVERRIDES, tiny_scene.UNBOUNDED_TINY):
        for sec, kv in over.items():
            for k, v in kv.items():
                cfg[sec][k] = v
    cfg.fine_train.update(N_iters=3, ray_sampler="patch_box", pg_scale=[])
    tt.train(_args(no_reload=True), cfg, tiny_scene.unbounded_scene(),
             device="cpu")
    out = capsys.readouterr().out
    assert "patch_box -> gather forward" in out
    assert "patch_box steps: 0 slab sweep, 3 gather forward" in out
