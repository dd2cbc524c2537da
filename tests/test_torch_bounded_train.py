"""Port parity of the bounded-scene ``run.py`` path: the JAX package's
``run.py`` trains ``configs/syn/syn_default.py`` cut by
``tools/tiny_scene.BOUNDED_OVERRIDES`` (coarse 60 steps with the per-voxel
lr, then fine 40 with ``in_maskcache`` and one grid doubling) on a tiny
Blender scene written to tmp, renders the test views and exports the
coarse volume; the port's ``trainer.train`` on the CPU trains the same
scene, and its ``run.main`` does what the JAX CLI did. Both packages'
rgbnet draws are replaced by one numpy draw, so the runs start equal.
Also: resume from a periodic file, and the ``maskout_lt_nviews`` option,
which the JAX package applies to DirectMPIGO only.

Tolerances: the loss at every step 1e-4 relative (float32 sums in another
order over 100 steps); the final grids within 1e-4 of the JAX run's
(measured 4e-5), but for k0 entries under a 2% share, each within 1e-2
(MaskedAdam moves an entry whose gradient is within rounding of zero by
about ``lr * sign(g)`` in one package and not the other: measured 1% of
them above 1e-4, none above 5e-3); the rgbnet 1e-4; the masks and the
configs equal; the rendered test views 1e-4; the exported alpha volume
1e-5. The resumed run replays the unbroken one: losses 1e-6 relative,
params 1e-5."""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import dvgo as jd
from fourk_nerf_tpu.train import checkpoints as jc
from fourk_nerf_torch import config as tconfig, run as trun
from fourk_nerf_torch.models import dvgo as td
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import checkpoints as tc, trainer as tt

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


def _rgbnet(cfg):
    """The rgbnet both packages start from: a numpy draw by the layer
    widths."""
    dims = [cfg.dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1) + [3]
    rng = np.random.default_rng(sum(dims))
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (rng.normal(0, 1, (a, b)) / np.sqrt(a)).astype(
            np.float32)
        out[f"b{i}"] = rng.normal(0, 0.1, b).astype(np.float32)
    return out


def _same_rgbnet(mp):
    """Patch both packages' ``dvgo.init`` to draw :func:`_rgbnet`."""
    jinit, tinit = jd.init, td.init

    def j_init(cfg, key, init_mask=None):
        params, buffers = jinit(cfg, key, init_mask=init_mask)
        if "rgbnet" in params:
            params["rgbnet"] = jax.tree.map(jnp.asarray, _rgbnet(cfg))
        return params, buffers

    def t_init(cfg, **kw):
        params, buffers = tinit(cfg, **kw)
        if "rgbnet" in params:
            dev = params["density"].device
            params["rgbnet"] = {k: torch.as_tensor(v, device=dev)
                                for k, v in _rgbnet(cfg).items()}
        return params, buffers

    mp.setattr(jd, "init", j_init)
    mp.setattr(td, "init", t_init)


def _write_blender(root, data):
    """``data`` (a ``bounded_scene``) as a Blender scene on disk."""
    import imageio.v2 as imageio

    names = {"train": data["i_train"], "val": data["i_val"],
             "test": data["i_test"]}
    for split, idx in names.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in idx:
            rgba = np.concatenate([data["images"][i], np.ones_like(
                data["images"][i][..., :1])], -1)
            imageio.imwrite(os.path.join(root, split, f"r_{i}.png"),
                            (rgba * 255 + 0.5).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": data["poses"][i].tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": tiny_scene.CAMERA_ANGLE_X,
                       "frames": frames}, f)


def _write_cfg(path, pkg, basedir, datadir, **extra):
    over = {**tiny_scene.BOUNDED_OVERRIDES}
    for section, kv in extra.items():
        over[section] = {**over.get(section, {}), **kv}
    lines = [f"_base_ = {os.path.join(ROOT, pkg, CFG)!r}",
             "expname = 'syn'", f"basedir = {basedir!r}",
             f"data = dict(datadir={datadir!r}, half_res=False, testskip=1)"]
    lines += [f"{k} = {v!r}" for k, v in over.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _jax_cli(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_run_cli", os.path.join(ROOT, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["run.py"] + argv
    try:
        mod.main()
    finally:
        sys.argv = old


def _losses(tsv):
    rows = [line.split("\t") for line in open(tsv)]
    return np.array([float(r[3]) for r in rows if r[2] == "train/loss"])


ARGS = ["--i_print", "1", "--i_val", "0", "--i_weights", "0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI's run and the port's ``trainer.train`` on one scene."""
    tmp = tmp_path_factory.mktemp("bounded")
    data = tiny_scene.bounded_scene()
    datadir = str(tmp / "scene")
    _write_blender(datadir, data)
    out = {"tmp": tmp, "datadir": datadir}
    with pytest.MonkeyPatch.context() as mp:
        # the TensorBoard writer is optional; its import is slow
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        _same_rgbnet(mp)
        for pkg in ("fourk_nerf_tpu", "fourk_nerf_torch"):
            path = str(tmp / f"{pkg}.py")
            _write_cfg(path, pkg, str(tmp / pkg), datadir)
            out[pkg] = path
        _jax_cli(["--config", out["fourk_nerf_tpu"], "--render_test",
                  "--dump_images"] + ARGS)
        _jax_cli(["--config", out["fourk_nerf_tpu"], "--export_coarse_only",
                  str(tmp / "jax_coarse.npz")])
        cfg = tconfig.load_config(out["fourk_nerf_torch"])
        out["data"] = trun.load_everything(None, cfg)
        rec = types.SimpleNamespace(rows=[])
        rec.scalar = lambda tag, v, step: rec.rows.append((tag, float(v)))
        args = types.SimpleNamespace(seed=777, no_reload=False,
                                     no_reload_optimizer=False, ft_path="",
                                     i_print=1, i_val=0, i_weights=0)
        out["model"] = tt.train(args, cfg, out["data"], writer=rec,
                                device="cpu")
        out["losses"] = np.array([v for tag, v in rec.rows
                                  if tag == "train/loss"])
    return out


def _jax_file(runs, name):
    return os.path.join(runs["tmp"], "fourk_nerf_tpu", "syn", name)


def test_train_matches_jax(runs):
    want = _losses(_jax_file(runs, os.path.join("tb", "scalars.tsv")))
    assert len(want) == 100 and len(runs["losses"]) == 100
    np.testing.assert_allclose(runs["losses"], want, rtol=1e-4)
    assert want[59] < want[0] and want[-1] < want[60]
    model_mod, mcfg, params, buffers = runs["model"]
    assert model_mod is td
    for stage in ("coarse", "fine"):
        kw, p, b, _, step, _ = jc.load_checkpoint(
            _jax_file(runs, f"{stage}_last.npz"))
        if stage == "fine":
            assert td.get_kwargs(mcfg) == kw
            got_p, got_b = params, buffers
        else:
            tkw, got_p, got_b, _, tstep, _ = tc.load_checkpoint(
                os.path.join(runs["tmp"], "fourk_nerf_torch", "syn",
                             "coarse_last.npz"), device="cpu")
            assert tkw == kw and tstep == step == 60
        np.testing.assert_array_equal(got_b["mask_cache"].numpy(),
                                      b["mask_cache"])
        for k in ("density", "k0"):
            d = np.abs(got_p[k].numpy() - p[k])
            if k == "density":
                assert d.max() <= 1e-4, (stage, k, d.max())
            else:
                assert np.mean(d > 1e-4) < 0.02 and d.max() <= 1e-2, \
                    (stage, k, np.mean(d > 1e-4), d.max())
        for k, v in p.get("rgbnet", {}).items():
            np.testing.assert_allclose(got_p["rgbnet"][k].numpy(), v,
                                       atol=1e-4, rtol=0, err_msg=k)
    assert mcfg.world_size == tuple(jd.make_config(**kw).world_size)
    # the fine mask came from the coarse run and was pruned by pg_scale
    assert 0 < int(buffers["mask_cache"].sum()) < buffers["mask_cache"].numel()


def test_cli_render_only_and_export_match_jax(runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _same_rgbnet(monkeypatch)
    cfg = runs["fourk_nerf_torch"]
    res = trun.main(["--config", cfg, "--device", "cpu", "--render_test"]
                    + ARGS)
    rundir = os.path.join(runs["tmp"], "fourk_nerf_torch", "syn")
    # the CLI ran where trainer.train had left its files: it reloaded them
    assert tuple(res["test"]["rgbs"].shape) == (2, 16, 16, 3)
    again = trun.main(["--config", cfg, "--device", "cpu", "--render_only",
                       "--render_test"])
    assert again["test"]["path"] == "box"
    assert torch.equal(again["test"]["rgbs"], res["test"]["rgbs"])
    # the JAX CLI's test views, from its own run
    import imageio.v2 as imageio
    want = np.stack([imageio.imread(_jax_file(runs, os.path.join(
        "render_test", f"{i:03d}.png"))) for i in range(2)]) / 255.0
    got = np.clip(again["test"]["rgbs"].numpy(), 0, 1)
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-4
    assert np.abs(got - 1.0).max() > 0.1  # the blob is seen
    np.testing.assert_allclose(again["test"]["psnrs"],
                               res["test"]["psnrs"], rtol=0)

    out = str(runs["tmp"] / "torch_coarse.npz")
    assert trun.main(["--config", cfg, "--device", "cpu",
                      "--export_coarse_only", out]) == {}
    with np.load(out) as got_z, np.load(
            str(runs["tmp"] / "jax_coarse.npz")) as want_z:
        assert set(got_z.files) == set(want_z.files) == {"alpha", "xyz_min",
                                                         "xyz_max"}
        np.testing.assert_allclose(got_z["alpha"], want_z["alpha"],
                                   atol=1e-5, rtol=0)
        assert got_z["alpha"].max() > 0.5
        for k in ("xyz_min", "xyz_max"):
            np.testing.assert_array_equal(got_z[k], want_z[k])
    assert os.path.isfile(os.path.join(rundir, "fine_last.npz"))


def test_resume_from_a_periodic_file_replays_the_run(runs, tmp_path,
                                                     monkeypatch):
    """A killed run resumed from its newest periodic file (step 25, after
    the grid doubled) replays the unbroken run's steps: the same losses
    and final params to float32 rounding (the CPU's scatter-adds sum in
    thread order: two fresh runs differ by ~1.5e-6). The fine stage draws
    from all rays here: ``in_maskcache`` takes the rays that meet the mask
    of the model it starts from, which a resumed run reads from the file,
    in both packages."""
    _same_rgbnet(monkeypatch)
    cfg = tconfig.load_config(runs["fourk_nerf_torch"])
    cfg.basedir = str(tmp_path)
    cfg.fine_train.ray_sampler = "flatten"
    args = types.SimpleNamespace(seed=777, no_reload=False,
                                 no_reload_optimizer=False, ft_path="",
                                 i_print=1, i_val=0, i_weights=25)
    rows = [[], []]
    out = []
    for rec in rows:
        w = types.SimpleNamespace(
            scalar=lambda tag, v, step, rec=rec: rec.append((step, float(v)))
            if tag == "train/loss" else None)
        out.append(tt.train(args, cfg, runs["data"], writer=w, device="cpu"))
        rundir = os.path.join(cfg.basedir, cfg.expname)
        if os.path.isfile(os.path.join(rundir, "fine_last.npz")):
            assert os.path.isfile(os.path.join(rundir, "fine_000025.npz"))
            os.remove(os.path.join(rundir, "fine_last.npz"))
    unbroken, resumed = rows[0][60:], rows[1]  # the fine steps
    assert [s for s, _ in resumed] == list(range(26, 41))
    np.testing.assert_allclose([v for _, v in resumed],
                               [v for s, v in unbroken if s > 25], rtol=1e-6)
    (_, c1, p1, b1), (_, c2, p2, b2) = out
    assert c2 == c1
    assert torch.equal(b2["mask_cache"], b1["mask_cache"])
    for k in ("density", "k0"):
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    for k, v in p1["rgbnet"].items():
        np.testing.assert_allclose(p2["rgbnet"][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_maskout_lt_nviews_is_for_the_mpi_model_only(runs, tmp_path,
                                                     monkeypatch):
    """The JAX package prunes the mask by the views' counts for DirectMPIGO
    only (trainer.py:802); a bounded run ignores the option, so its mask
    is that of the same run without it."""
    _same_rgbnet(monkeypatch)
    masks = []
    for n in (0, 3):
        cfg = tconfig.load_config(runs["fourk_nerf_torch"])
        cfg.basedir = str(tmp_path / f"lt{n}")
        cfg.coarse_train.N_iters = 0
        cfg.fine_train.update(N_iters=3, pg_scale=[], ray_sampler="random",
                              maskout_lt_nviews=n)
        args = types.SimpleNamespace(seed=777, no_reload=True,
                                     no_reload_optimizer=False, ft_path="",
                                     i_print=0, i_val=0, i_weights=0)
        masks.append(tt.train(args, cfg, runs["data"], device="cpu")[3]
                     ["mask_cache"])
    assert torch.equal(masks[0], masks[1])
