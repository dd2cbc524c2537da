"""Port parity of the encoder's training loop: one train step vs the JAX
package's ``make_train_step(donate=False)``, ``scene_rep_reconstruction``
through one progressive-scaling boundary vs the JAX loop from the same
initial checkpoint, bit-exact resume within the port on the CPU, resume by
the parsed step, and the CLI ``python -m fourk_nerf_torch.run`` on a tiny
LLFF scene.

Tolerances: loss 1e-5 relative; gradients within 1e-5 of each leaf's
largest entry. Params after MaskedAdam: the first step after a reset
moves an entry by ``lr * sign(g)``, so a gradient within rounding of zero
can move it in one package and not in the other; such entries are
allowed, in a share below 1e-3 of entries off by more than 1e-4. Per-step
losses of the 10-step runs: 1e-4 relative."""

import os
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.models import dmpigo as jd
from fourk_nerf_tpu.train import checkpoints as jc, optim as jo, \
    trainer as jt
from fourk_nerf_torch import config as tconfig, weights
from fourk_nerf_torch.models import dmpigo as td
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import checkpoints as tc, optim as to, \
    trainer as tt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "llff", "fern_lg_pretrain.py")


def _cfgs(tmp, expname="tiny", **fine_train):
    over = {**tiny_scene.OVERRIDES,
            "fine_train": {**tiny_scene.OVERRIDES["fine_train"],
                           **fine_train}}
    j = tiny_scene.apply_overrides(
        jconfig.load_config(os.path.join(ROOT, "fourk_nerf_tpu", CFG)),
        str(tmp / "jax"), expname, over)
    t = tiny_scene.apply_overrides(
        tconfig.load_config(os.path.join(ROOT, "fourk_nerf_torch", CFG)),
        str(tmp / "torch"), expname, over)
    return j, t


def _args(**kw):
    base = dict(seed=0, no_reload=False, no_reload_optimizer=False,
                ft_path="", i_print=1, i_val=0, i_weights=0)
    return types.SimpleNamespace(**{**base, **kw})


class Recorder:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def losses(self):
        return [v for tag, v, _ in self.rows if tag == "train/loss"]


def _init_checkpoint(jcfg_all, data, path, seed=0):
    """A JAX-format checkpoint of the first phase's model, numpy-drawn, that
    both packages start from (``--ft_path``)."""
    xyz_min, xyz_max = jt.compute_bbox_by_cam_frustrm(
        jcfg_all, data["HW"], data["Ks"], data["poses"], data["i_train"],
        data["near"], data["far"])
    kw = dict(jcfg_all.fine_model_and_render)
    n = int(kw.pop("num_voxels") / 2 ** len(jcfg_all.fine_train.pg_scale))
    mcfg = jt._make_cfg(jd, jcfg_all, xyz_min, xyz_max, n, kw)
    params, buffers = jd.init(mcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    params["density"] = rng.normal(0, 1, params["density"].shape).astype(
        np.float32)
    params["k0"] = rng.normal(0, 1, params["k0"].shape).astype(np.float32)
    jc.save_checkpoint(path, jd.get_kwargs(mcfg), params,
                       jax.tree.map(np.asarray, buffers))
    return mcfg, params, jax.tree.map(np.asarray, buffers)


def _frac_off(a, b, thr=1e-4):
    return float(np.mean(np.abs(np.asarray(a) - np.asarray(b)) > thr))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    v = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return {prefix[:-1]: v}


@pytest.mark.parametrize("tv_dense", [True, False])
def test_train_step_matches_jax(tmp_path, tv_dense):
    jcfg_all, tcfg_all = _cfgs(tmp_path)
    # TV weights large enough to move the step
    for c in (jcfg_all, tcfg_all):
        c.fine_train.weight_tv_density = 1e-2
        c.fine_train.weight_tv_k0 = 1e-3
    data = tiny_scene.scene()
    mcfg, params, buffers = _init_checkpoint(jcfg_all, data,
                                             str(tmp_path / "init.npz"))
    tmcfg = td.make_config(**jd.get_kwargs(mcfg))
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "rand_bkgd": True,
          "stepsize": 1.0, "ndc_planes": True}
    assert jd.plane_aligned_ok(mcfg, 1.0, True)
    ro, rd, vd = (np.array(a).reshape(-1, 3)[::5][:128] for a in
                  jax.tree.map(np.asarray, jt.ray_ops.get_rays_of_a_view(
                      24, 32, data["Ks"][1], data["poses"][1], ndc=True,
                      inverse_y=False, flip_x=False, flip_y=False)))
    target = data["images"][1].reshape(-1, 3)[::5][:128]
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, (128, 3)))
    lrs = jo.build_group_lrs(jcfg_all.fine_train, params)
    skip = frozenset(jcfg_all.fine_train.skip_zero_grad_fields)

    jstep = jt.make_train_step(jd, mcfg, jcfg_all.fine_train,
                               render_kwargs=rk, skip_zero_grad=skip,
                               donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jp2, js2, jloss, jpsnr, _ = jstep(
        jp, jax.tree.map(jnp.asarray, buffers), jo.init_state(jp),
        tuple(jnp.asarray(a) for a in (ro, rd, vd, target)), lrs, None, key,
        apply_tv=True, tv_dense=tv_dense)

    # the gradients the JAX step applies: its loss with the TV added
    def jloss_fn(p):
        out = jd.forward(mcfg, p, jax.tree.map(jnp.asarray, buffers),
                         *(jnp.asarray(a) for a in (ro, rd, vd)),
                         stepsize=1.0, bg=0.0, rand_bkgd=True, is_train=True,
                         key=key, ndc_planes=True)
        return jt.losses.encoder_losses(out, jnp.asarray(target),
                                        jcfg_all.fine_train, 128)[0]

    jg = jax.jit(jax.grad(jloss_fn))(jp)
    jg["density"] = jg["density"] + jd.density_tv_grad(
        mcfg, jp, 1e-2, tv_dense, 128, jg["density"])
    jg["k0"] = jg["k0"] + jd.k0_tv_grad(mcfg, jp, 1e-3, tv_dense, 128,
                                        jg["k0"])

    tp, tb = weights.dmpigo_from_numpy(params, buffers, device="cpu")
    step = tt.TrainStep(td, tmcfg, tcfg_all.fine_train, render_kwargs=rk,
                        skip_zero_grad=skip)
    batch = tuple(torch.as_tensor(a) for a in (ro, rd, vd, target))
    tloss, _, tg = step.loss_and_grads(tp, tb, batch, lrs.keys(),
                                       torch.as_tensor(noise))
    step.add_tv(tp, tg, 128, tv_dense)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k, want in _flat(jg).items():
        got = _flat(tg)[k]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    # the whole step: MaskedAdam on these gradients, in place
    ts = to.init_state(tp)
    loss, psnr = step(tp, tb, ts, batch, lrs, None, torch.as_tensor(noise),
                      apply_tv=True, tv_dense=tv_dense)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(psnr.item(), float(jpsnr), rtol=1e-5)
    assert ts["step"] == 1
    for k, want in _flat(jp2).items():
        assert _frac_off(_flat(tp)[k], want) < 1e-3, k


def test_scene_rep_reconstruction_matches_jax(tmp_path):
    """10 steps through the pg_scale boundary at 5 (the optimizer reset,
    the grid doubling and the act_shift decay) and the dense -> sparse TV
    switch at 4, from one initial checkpoint, rays drawn by the same
    stream."""
    jcfg_all, tcfg_all = _cfgs(tmp_path)
    data = tiny_scene.scene()
    init = str(tmp_path / "init.npz")
    _init_checkpoint(jcfg_all, data, init)
    xyz = jt.compute_bbox_by_cam_frustrm(
        jcfg_all, data["HW"], data["Ks"], data["poses"], data["i_train"],
        0.0, 1.0)
    txyz = tt.compute_bbox_by_cam_frustrm(
        tcfg_all, data["HW"], data["Ks"], data["poses"], data["i_train"],
        0.0, 1.0, device="cpu")
    np.testing.assert_array_equal(txyz[0], xyz[0])
    np.testing.assert_array_equal(txyz[1], xyz[1])
    jw, tw = Recorder(), Recorder()
    _, jcfg, jp, jb = jt.scene_rep_reconstruction(
        _args(ft_path=init), jcfg_all, jcfg_all.fine_model_and_render,
        jcfg_all.fine_train, *xyz, data, stage="fine", writer=jw)
    _, tcfg, tp, tb = tt.scene_rep_reconstruction(
        _args(ft_path=init), tcfg_all, tcfg_all.fine_model_and_render,
        tcfg_all.fine_train, *txyz, data, stage="fine", writer=tw,
        device="cpu")
    assert tcfg.world_size == jcfg.world_size
    assert len(tw.losses()) == len(jw.losses()) == 10
    np.testing.assert_allclose(tw.losses(), jw.losses(), rtol=1e-4)
    for k, want in _flat(jp).items():
        assert _frac_off(_flat(tp)[k], want) < 1e-3, k
    np.testing.assert_array_equal(tb["mask_cache"].numpy(),
                                  np.asarray(jb["mask_cache"]))
    np.testing.assert_allclose(tb["act_shift"].numpy(),
                               np.asarray(jb["act_shift"]), atol=1e-6)
    # the final checkpoint of the port loads in the JAX package
    kw, p, _, o, step, meta = jc.load_checkpoint(
        str(tmp_path / "torch" / "tiny" / "fine_last.npz"))
    assert step == 10 and meta["steps_since_reset"] == 6  # steps 5-10
    assert int(o["step"]) == 6 and tuple(kw["mask_cache_world_size"]) == \
        tcfg.mask_cache_world_size


def _params_and_state(tmp, name):
    _, p, _, o, step, _ = tc.load_checkpoint(
        str(tmp / "torch" / name / "fine_last.npz"), device="cpu")
    return _flat({"p": p, "o": {k: o[k] for k in ("exp_avg",
                                                  "exp_avg_sq")}}), o, step


def test_resume_is_bit_exact_on_the_cpu(tmp_path):
    """An unbroken 10-step run against 7 steps, a checkpoint and a resume
    to 10, past the pg_scale boundary at 5 and with the random background
    on: the same params, moments and step count, bitwise."""
    data = tiny_scene.scene()

    def run(name, n_iters):
        _, t = _cfgs(tmp_path, name, N_iters=n_iters)
        t.data.rand_bkgd = True
        tt.train(_args(i_print=0), t, data, device="cpu")

    run("A", 10)
    run("B", 7)
    run("B", 10)  # resumes from B's fine_last at step 7
    a, oa, sa = _params_and_state(tmp_path, "A")
    b, ob, sb = _params_and_state(tmp_path, "B")
    assert sa == sb == 10 and oa["step"] == ob["step"] == 6
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_resume_picks_the_largest_parsed_step(tmp_path):
    rundir = tmp_path / "run"
    rundir.mkdir()
    for name in ("fine_999999.npz", "fine_1000000.npz", "fine_000010.npz",
                 "fine_2000000.npz.tmp.npz", "best_psnr.npz",
                 "coarse_3000000.npz"):
        (rundir / name).write_bytes(b"")
    assert tt.find_reload_path(_args(), str(rundir), "fine") == \
        str(rundir / "fine_1000000.npz")
    # the JAX package's lexicographic choice, which the port does not copy
    assert jt.os.path.basename(max(str(p) for p in rundir.glob(
        "fine_[0-9]*.npz") if not str(p).endswith(".tmp.npz"))) == \
        "fine_999999.npz"
    (rundir / "fine_last.npz").write_bytes(b"")
    assert tt.find_reload_path(_args(), str(rundir), "fine").endswith(
        "fine_last.npz")
    assert tt.find_reload_path(_args(ft_path="x.tar"), str(rundir),
                               "fine") == "x.tar"
    assert tt.find_reload_path(_args(no_reload=True), str(rundir),
                               "fine") is None


def _bounded_cfg(tmp_path, **train):
    """``syn_default`` cut to the tiny bounded scene, 6 + 6 steps."""
    t = tconfig.load_config(os.path.join(ROOT, "fourk_nerf_torch", "configs",
                                         "syn", "syn_default.py"))
    t.basedir, t.expname = str(tmp_path / "torch"), "tiny"
    for sec, kv in tiny_scene.BOUNDED_OVERRIDES.items():
        for k, v in kv.items():
            t[sec][k] = v
    for sec in ("coarse_train", "fine_train"):
        t[sec].update(N_iters=6, pg_scale=[])
        t[sec].update(train.get(sec, {}))
    return t


@pytest.mark.parametrize("change,route", [
    (dict(fine_model_and_render=dict(dim_rend=6)), None),
    (dict(fine_train=dict(ray_sampler="patch_box")), "gather"),
    # a bounded run, both stages on the slab sweep
    (dict(coarse_train=dict(ray_sampler="patch_box"),
          fine_train=dict(ray_sampler="patch_box")), "slab"),
    (dict(coarse_train=dict(ray_sampler="patch_box")), "slab"),
])
def test_former_queue_a_paths_train(tmp_path, capsys, change, route):
    """What raised up front before ``dim_rend > 3`` and ``patch_box`` were
    ported now trains: the rend layer on the tiny NDC scene (its i_val
    render chunked), ``patch_box`` on a DirectMPIGO through its gather
    forward, and on a bounded DirectVoxGO through the slab sweep. Torch
    runs on one intra-op thread, as in the other bounded tests: beside the
    other test workers its small ops would wait for busy cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_former_path(tmp_path, capsys, change, route)
    finally:
        torch.set_num_threads(n_threads)


def _train_former_path(tmp_path, capsys, change, route):
    if "coarse_train" in change:
        t = _bounded_cfg(tmp_path, **change)
        data = tiny_scene.bounded_scene()
    else:
        _, t = _cfgs(tmp_path)
        for section, kv in change.items():
            for k, v in kv.items():
                t[section][k] = v
        data = tiny_scene.scene()
    w = Recorder()
    _, mcfg, params, _ = tt.train(_args(i_val=5), t, data, writer=w,
                                  device="cpu")
    assert np.all(np.isfinite(w.losses())) and len(w.losses()) >= 6
    if route is None:
        assert mcfg.dim_rend == 6 and "rend_layer" in params
    else:
        stage = "coarse" if "coarse_train" in change else "fine"
        n = {"slab": 0, "gather": 0, route: t[f"{stage}_train"].N_iters}
        assert (f"({stage}): patch_box steps: {n['slab']} slab sweep, "
                f"{n['gather']} gather forward") in capsys.readouterr().out


def test_cli_trains_and_renders_the_test_views(tmp_path):
    from test_torch_config_data import _write_llff_scene

    scene = tmp_path / "scene"
    _write_llff_scene(str(scene), n=5, h=12, w=16)
    cfg = tmp_path / "tiny_cfg.py"
    over = tiny_scene.OVERRIDES
    cfg.write_text(
        f"_base_ = {os.path.join(ROOT, 'fourk_nerf_torch', CFG)!r}\n"
        f"expname = 'cli'\nbasedir = {str(tmp_path / 'logs')!r}\n"
        f"data = dict(datadir={str(scene)!r}, llffhold=2, **{over['data']!r})\n"
        f"fine_train = {over['fine_train']!r}\n"
        f"fine_model_and_render = {over['fine_model_and_render']!r}\n")
    cmd = [sys.executable, "-m", "fourk_nerf_torch.run", "--config",
           str(cfg), "--device", "cpu", "--i_print", "5", "--i_val", "0",
           "--render_test", "--dump_images"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "render_viewpoints: psnr" in out.stdout and "done" in out.stdout
    rundir = tmp_path / "logs" / "cli"
    assert (rundir / "fine_last.npz").is_file()
    assert sorted(os.listdir(rundir / "render_test")) == \
        ["000.png", "001.png", "002.png"]
    # --render_only reloads fine_last and renders the same frames
    out2 = subprocess.run(cmd + ["--render_only"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert out2.returncode == 0, out2.stderr[-3000:]
    psnr = [line for line in out.stdout.splitlines()
            if line.startswith("render_viewpoints")]
    assert psnr == [line for line in out2.stdout.splitlines()
                    if line.startswith("render_viewpoints")]
