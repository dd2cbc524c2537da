"""Port parity of the unbounded-inward path (DirectContractedVoxGO through
``run.py``): the JAX package's root ``run.py`` trains
``configs/syn/syn_default.py`` with ``tools/tiny_scene.UNBOUNDED_OVERRIDES``
and ``UNBOUNDED_TINY`` (30 steps at 16^3, the grid doubling at step 15,
the near-clip and distortion losses) on ``tiny_scene.unbounded_scene()``
written to tmp as a NeRF++ capture, renders the test views and exports
the box and cameras; the port's ``trainer.train`` on the CPU trains the
same scene, and its ``run.main`` does what the JAX CLI did. Both
packages' rgbnet draws are replaced by one numpy draw. Also: the
unbounded box rule, the configs whose stages JAX runs on this family
(the per-voxel lr, a coarse stage) and the one it cannot (``in_maskcache``),
and the joint trainer's encoder family on an unbounded scene.

Tolerances: the loss at every step 1e-4 relative (float32 sums in another
order, and sample points a few ulps apart where XLA fuses multiply-adds:
``tests/test_torch_dcvgo.py``); the final density and k0 within 1e-3 of
the JAX run's, but for a 2% share of k0 entries within 1e-2 (MaskedAdam
moves an entry whose gradient is within rounding of zero by ``lr *
sign(g)`` in one package and not the other); the rgbnet 1e-3; the masks
and configs equal; the rendered test views within 1/255 + 1e-3 of the
JAX CLI's PNGs; the exported box and cameras equal; the joint trainer's
first-step terms 1e-5 relative."""

import importlib.util
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.models import dcvgo as jd, dvgo as jdv, \
    sr_esrnet as jsr
from fourk_nerf_tpu.train import checkpoints as jc, sr_trainer as jst, \
    trainer as jt
from fourk_nerf_torch import config as tconfig, run as trun
from fourk_nerf_torch.models import dcvgo as td, dvgo as tdv, \
    sr_esrnet as tsr
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import sr_trainer as tst, trainer as tt
from test_torch_loaders import write_nerfpp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "syn", "syn_default.py")
ARGS = ["--i_print", "1", "--i_val", "0", "--i_weights", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgbnet(dim0, width, depth):
    dims = [dim0] + [width] * (depth - 1) + [3]
    rng = np.random.default_rng(sum(dims))
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (rng.normal(0, 1, (a, b)) / np.sqrt(a)).astype(
            np.float32)
        out[f"b{i}"] = rng.normal(0, 0.1, b).astype(np.float32)
    return out


def _same_rgbnet(mp, *mods):
    """Patch ``init`` of both packages' modules ``mods`` (pairs) to draw
    the rgbnet from :func:`_rgbnet`."""
    for jmod, tmod in mods:
        def j_init(cfg, key, init_mask=None, _f=jmod.init):
            params, buffers = _f(cfg, key, init_mask=init_mask)
            if "rgbnet" in params:
                w = params["rgbnet"]
                params["rgbnet"] = jax.tree.map(jnp.asarray, _rgbnet(
                    w["w0"].shape[0], w["w0"].shape[1], len(w) // 2))
            return params, buffers

        def t_init(cfg, _f=tmod.init, **kw):
            params, buffers = _f(cfg, **kw)
            if "rgbnet" in params:
                w, dev = params["rgbnet"], params["density"].device
                params["rgbnet"] = {k: torch.as_tensor(v, device=dev)
                                    for k, v in _rgbnet(
                    w["w0"].shape[0], w["w0"].shape[1], len(w) // 2).items()}
            return params, buffers

        mp.setattr(jmod, "init", j_init)
        mp.setattr(tmod, "init", t_init)


def _cut(cfg, basedir, expname="unb", datadir=None):
    for over in (tiny_scene.UNBOUNDED_OVERRIDES, tiny_scene.UNBOUNDED_TINY):
        tiny_scene.apply_overrides(cfg, basedir, expname, over)
    if datadir is not None:
        cfg.data.update(dataset_type="nerfpp", datadir=datadir)
    return cfg


def _write_cfg(path, pkg, basedir, datadir):
    lines = [f"_base_ = {os.path.join(ROOT, pkg, CFG)!r}",
             "expname = 'unb'", f"basedir = {basedir!r}"]
    over = {}
    for o in (tiny_scene.UNBOUNDED_OVERRIDES, tiny_scene.UNBOUNDED_TINY):
        for section, kv in o.items():
            over[section] = {**over.get(section, {}), **kv}
    over["data"].update(dataset_type="nerfpp", datadir=datadir)
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


def _args(**kw):
    base = dict(seed=777, no_reload=True, no_reload_optimizer=False,
                ft_path="", i_print=1, i_val=0, i_weights=0)
    return types.SimpleNamespace(**{**base, **kw})


class Recorder:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def values(self, tag):
        return [v for t, v, _ in self.rows if t == tag]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI's run and the port's ``trainer.train`` on one scene."""
    tmp = tmp_path_factory.mktemp("unbounded")
    data = tiny_scene.unbounded_scene()
    datadir = str(tmp / "scene")
    images = (np.clip(data["images"], 0, 1) * 255 + 0.5).astype(np.uint8)
    write_nerfpp(datadir, images, data["poses"], data["Ks"][0],
                 data["i_train"], np.r_[data["i_val"], data["i_test"]])
    out = {"tmp": tmp, "datadir": datadir}
    with pytest.MonkeyPatch.context() as mp:
        # the TensorBoard writer is optional; its import is slow
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        _same_rgbnet(mp, (jd, td))
        for pkg in ("fourk_nerf_tpu", "fourk_nerf_torch"):
            path = str(tmp / f"{pkg}.py")
            _write_cfg(path, pkg, str(tmp / pkg), datadir)
            out[pkg] = path
        _jax_cli(["--config", out["fourk_nerf_tpu"], "--render_test",
                  "--dump_images"] + ARGS)
        _jax_cli(["--config", out["fourk_nerf_tpu"],
                  "--export_bbox_and_cams_only", str(tmp / "jax_bbox.npz")])
        cfg = tconfig.load_config(out["fourk_nerf_torch"])
        out["data"] = trun.load_everything(None, cfg)
        rec = Recorder()
        out["model"] = tt.train(_args(no_reload=False), cfg, out["data"],
                                writer=rec, device="cpu")
        out["losses"] = np.array(rec.values("train/loss"))
    return out


def _jax_file(runs, name):
    return os.path.join(runs["tmp"], "fourk_nerf_tpu", "unb", name)


def test_train_matches_jax(runs):
    want = _losses(_jax_file(runs, os.path.join("tb", "scalars.tsv")))
    assert len(want) == 30 and len(runs["losses"]) == 30
    np.testing.assert_allclose(runs["losses"], want, rtol=1e-4)
    assert np.mean(want[-5:]) < np.mean(want[:5])
    model_mod, mcfg, params, buffers = runs["model"]
    assert model_mod is td
    kw, p, b, _, step, _ = jc.load_checkpoint(_jax_file(runs,
                                                        "fine_last.npz"))
    assert td.get_kwargs(mcfg) == kw and step == 30
    assert mcfg.world_size == jd.make_config(**kw).world_size == (15,) * 3
    np.testing.assert_array_equal(buffers["mask_cache"].numpy(),
                                  b["mask_cache"])
    for k in ("density", "k0"):
        d = np.abs(params[k].numpy() - p[k])
        assert np.mean(d > 1e-3) < 0.02 and d.max() <= 1e-2, \
            (k, np.mean(d > 1e-3), d.max())
        if k == "density":
            assert d.max() <= 1e-3, d.max()
    for k, v in p["rgbnet"].items():
        np.testing.assert_allclose(params["rgbnet"][k].numpy(), v,
                                   atol=1e-3, rtol=0, err_msg=k)


def test_cli_render_only_export_and_video(runs, monkeypatch):
    import imageio.v2 as imageio

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = runs["fourk_nerf_torch"]
    res = trun.main(["--config", cfg, "--device", "cpu", "--render_only",
                     "--render_test", "--render_video"])
    test = res["test"]
    assert test["path"] == "chunked" and tuple(test["rgbs"].shape) == \
        (3, 16, 16, 3)
    n = len(runs["data"]["i_test"])
    want = np.stack([imageio.imread(_jax_file(runs, os.path.join(
        "render_test", f"{i:03d}.png"))) for i in range(n)]) / 255.0
    got = np.clip(test["rgbs"].numpy(), 0, 1)
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-3
    # the trained views beat a white frame (the untrained background)
    white = [-10 * np.log10(np.mean((1.0 - runs["data"]["images"][i]) ** 2))
             for i in runs["data"]["i_test"]]
    assert np.mean(test["psnrs"]) > np.mean(white) + 2
    assert tuple(res["video"]["rgbs"].shape) == (3, 16, 16, 3)  # test poses
    assert torch.equal(res["video"]["rgbs"], test["rgbs"])
    out = str(runs["tmp"] / "torch_bbox.npz")
    assert trun.main(["--config", cfg, "--device", "cpu",
                      "--export_bbox_and_cams_only", out]) == {}
    with np.load(out) as g, np.load(str(runs["tmp"] / "jax_bbox.npz")) as w:
        assert set(g.files) == set(w.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_unbounded_bbox_rule_matches_jax():
    data = tiny_scene.unbounded_scene()
    for inner_r in (1.0, 0.7):
        cfgs = [tiny_scene.apply_overrides(
            m.load_config(os.path.join(ROOT, pkg, CFG)), "x", "x",
            tiny_scene.UNBOUNDED_OVERRIDES)
            for m, pkg in ((jconfig, "fourk_nerf_tpu"),
                           (tconfig, "fourk_nerf_torch"))]
        for c in cfgs:
            c.data.unbounded_inner_r = inner_r
        keys = ("HW", "Ks", "poses", "i_train", "near", "far")
        want = jt.compute_bbox_by_cam_frustrm(
            cfgs[0], *(data[k] for k in keys), near_clip=data["near_clip"])
        got = tt.compute_bbox_by_cam_frustrm(
            cfgs[1], *(data[k] for k in keys), near_clip=data["near_clip"],
            device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        ext = got[1] - got[0]
        assert np.allclose(ext, ext[0])
        if inner_r == 1.0:  # the near-clip points' cube: about the cameras
            cams = data["poses"][data["i_train"], :3, 3]
            assert np.all(cams >= got[0] - 0.2)
            assert np.all(cams <= got[1] + 0.2)
    # without a near_clip the rule takes near
    got = tt.compute_bbox_by_cam_frustrm(
        cfgs[1], *(data[k] for k in keys), device="cpu")
    want = jt.compute_bbox_by_cam_frustrm(cfgs[0], *(data[k] for k in keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("change", [
    dict(fine_train=dict(pervoxel_lr=True)),
    dict(coarse_train=dict(N_iters=3, N_rand=64)),
])
def test_stages_jax_runs_on_this_family(tmp_path, monkeypatch, change):
    """The per-voxel lr counts the views on the contracted cube, and a
    coarse stage trains a DirectContractedVoxGO whose box is read as a
    DirectVoxGO's: what the JAX package does, the port does."""
    _same_rgbnet(monkeypatch, (jd, td))
    data = tiny_scene.unbounded_scene()
    out = []
    for m, pkg, run in ((jconfig, "fourk_nerf_tpu", jt.train),
                        (tconfig, "fourk_nerf_torch", tt.train)):
        cfg = _cut(m.load_config(os.path.join(ROOT, pkg, CFG)),
                   str(tmp_path / pkg))
        cfg.fine_train.update(N_iters=3, pg_scale=[], N_rand=64)
        cfg.coarse_model_and_render.update(num_voxels=8 ** 3,
                                           num_voxels_base=8 ** 3)
        for section, kv in change.items():
            cfg[section].update(kv)
        kw = {} if run is jt.train else {"device": "cpu"}
        out.append(run(_args(i_print=0), cfg, data, **kw))
    (jm, jcfg, _, jb), (tm, tcfg, tp, tb) = out
    assert jm is jd and tm is td
    assert td.get_kwargs(tcfg) == jd.get_kwargs(jcfg)
    np.testing.assert_array_equal(tb["mask_cache"].numpy(),
                                  np.asarray(jb["mask_cache"]))
    if "fine_train" in change:  # the view counts pruned the mask
        assert not bool(tb["mask_cache"].all())
    assert all(bool(torch.isfinite(v).all()) for v in
               (tp["density"], tp["k0"]))


@pytest.mark.parametrize("stage", ["fine_train", "coarse_train"])
def test_in_maskcache_raises_up_front(tmp_path, stage):
    """DirectContractedVoxGO has no hit test for ``in_maskcache`` (the JAX
    package fails on it with an AttributeError after any coarse stage):
    the port refuses before training."""
    cfg = _cut(tconfig.load_config(os.path.join(ROOT, "fourk_nerf_torch",
                                                CFG)), str(tmp_path))
    if stage == "coarse_train":
        cfg.coarse_train.N_iters = 3
    cfg[stage].ray_sampler = "in_maskcache"
    with pytest.raises(ValueError, match="no hit test"):
        tt.train(_args(), cfg, tiny_scene.unbounded_scene(), device="cpu")
    assert not any((tmp_path / "unb").glob("*.npz"))


# --- the joint trainer on an unbounded scene ---------------------------------

JOINT_CFG = os.path.join("configs", "syn", "chair_joint_1x_l1_gan.py")
PATCH = 8


def _tiny_sftnet(mp, rng):
    """Both packages' joint trainers build a one-block 8-feature SFTNet
    with the same numpy-drawn weights."""
    orig_j, orig_t = jsr.SFTNet, tsr.SFTNet
    small = dict(num_feat=8, num_block=1, num_grow_ch=4)
    shapes = jax.eval_shape(
        orig_j(n_in_colors=3, scale=1, num_cond=1, **small).init,
        jax.random.PRNGKey(0), jnp.zeros((1, PATCH, PATCH, 3)),
        jnp.zeros((1, PATCH, PATCH, 1)))["params"]
    tree = jax.tree.map(lambda s: rng.normal(
        0, 0.3 / np.sqrt(np.prod(s.shape[:-1]) or 1), s.shape).astype(
        np.float32), shapes)

    class Fixed(orig_j):
        def init(self, *a, **k):
            return {"params": jax.tree.map(jnp.asarray, tree)}

    mp.setattr(jsr, "SFTNet", lambda **kw: Fixed(**{**kw, **small}))
    mp.setattr(tsr, "SFTNet", lambda **kw: orig_t(**{**kw, **small}))
    from fourk_nerf_torch import weights
    mp.setattr(tsr, "init_like_jax",
               lambda model, gen: weights.load_flax_convs(model, tree))


def test_joint_trainer_builds_the_jax_family(tmp_path, monkeypatch):
    """On an unbounded (not NDC) scene the joint trainer's encoder is a
    DirectVoxGO on the unbounded box, in both packages; the first step's
    terms agree."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _same_rgbnet(monkeypatch, (jdv, tdv))
    _tiny_sftnet(monkeypatch, np.random.default_rng(9))
    data = tiny_scene.unbounded_scene()
    data["srgt"] = data["images"]
    data["w2c"] = np.stack([np.eye(3, dtype=np.float32)] * len(data["poses"]))
    recs, models = [], []
    for m, pkg in ((jconfig, "fourk_nerf_tpu"), (tconfig, "fourk_nerf_torch")):
        cfg = m.load_config(os.path.join(ROOT, pkg, JOINT_CFG))
        cfg.basedir, cfg.expname = str(tmp_path / pkg), "joint"
        cfg.data.update(unbounded_inward=True, unbounded_inner_r=1.0)
        cfg.fine_train.update(N_iters=1, N_patch=PATCH, pg_scale=[],
                              weight_gan=0.0, weight_pcp=0.0,
                              weight_style=0.0)
        cfg.fine_model_and_render.update(num_voxels=12 ** 3,
                                         num_voxels_base=12 ** 3,
                                         rgbnet_width=16)
        args = types.SimpleNamespace(
            seed=777, no_reload=True, no_reload_optimizer=False, ft_path="",
            ftdv_path="", ftdvcoa_path="", ftsr_path="", i_print=1, i_val=0,
            i_weights=0, test_tile=0)
        rec = Recorder()
        if pkg == "fourk_nerf_tpu":  # the JAX run_sr.py's training branch
            box = jt.compute_bbox_by_cam_frustrm(
                cfg, data["HW"], data["Ks"], data["poses"], data["i_train"],
                data["near"], data["far"], near_clip=data["near_clip"])
            models.append(jst.scene_rep_reconstruction_sr_patch(
                args, cfg, cfg.fine_model_and_render, cfg.fine_train, *box,
                data, stage="fine", writer=rec)[:4])
        else:
            models.append(tst.train_sr(args, cfg, data, writer=rec,
                                       device="cpu")[:4])
        recs.append({t: v for t, v, _ in rec.rows})
    (jm, jcfg, _, _), (tm, tcfg, _, _) = models
    assert jm is jdv and tm is tdv
    assert tdv.get_kwargs(tcfg) == jdv.get_kwargs(jcfg)
    want, got = recs
    assert {"train/loss_photo", "train/loss_l1"} <= set(want)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
