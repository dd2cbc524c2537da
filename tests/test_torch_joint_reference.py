"""The joint step of the port (``sr_trainer.JointSteps`` over
``SRTrainStep``) against the benchmark's plain reference
(``portbench/reference/joint.py``), on the CPU at toy sizes with seeded
random weights, no JAX: the losses, the first step's gradients of both
trees (the encoder's and the generator's) and the parameters after three
steps, on the grid-window path (steps after TV) and on the full-grid
sweep (steps with TV); the windowed MaskedAdam against the reference's
full-grid update; two faults the comparison must catch; the joint loop
and a driver's loop over ``JointSteps`` on the same draws; and the step's
spans and counter.

Tolerances. The reference rounds to bfloat16 where the sweep does, so the
two differ only where a float32 sum taken in another order (the rays'
grid positions, the bilinear sums, the decoder's convolutions) moves a
value across a bfloat16 rounding boundary or a mask decision (measured:
losses within 9e-8, gradients within 4e-7 of a leaf's largest entry but
the rgbnet's 7e-6, 1.2e-5 of a grid's entries moved apart). Losses within
1e-6 relative; each leaf's gradient within 1e-5 of its largest entry for
the grids and the generator (float32 sums in another order), within 2^-8
for the rgbnet, whose gradients are bfloat16 products (a product that
rounds the other way moves an entry by at most one bfloat16 ulp, 2^-8 of
the largest); after three steps the entries MaskedAdam moved (about
``lr * sign(g)`` each) may differ where a gradient sits within rounding of
zero: at most 1e-4 of a leaf's entries off by more than 1e-6."""

import os
import types

import numpy as np
import pytest
import torch

from fourk_nerf_torch import config as tconfig
from fourk_nerf_torch.models import dmpigo
from fourk_nerf_torch.ops import plane_sweep
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import optim, sr_trainer, trainer
from fourk_nerf_torch.utils import trace
from portbench import inputs, judge, run
from portbench.drivers import joint as joint_driver
from portbench.drivers import train as train_driver
from portbench.reference import train as ref_train
from portbench.tests.test_portbench_joint import CELL, SEED, shrunk_joint

CPU = torch.device("cpu")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WINDOW_START = 10001  # after tv_before: the grid window
SWEEP_START = 2       # TV on: the full-grid sweep


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's small
    parallel ops would wait on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    torch.set_num_threads(n)


def _cell(start: int):
    cfg = shrunk_joint(inputs.config, "fern_lg_joint")
    tr = {**inputs.traffic("joint_l1"), "start_step": start}
    poses = inputs.views(tr["views"], cfg["data"]["train_views"], SEED)
    imgs = inputs.images(len(poses), cfg["camera"], SEED)
    hr = joint_driver.hr_images(len(poses), cfg["camera"],
                                cfg["decoder"]["scale"], SEED, CPU)
    params, buffers = inputs.scene(cfg, SEED, CPU)
    weights = inputs.decoder(cfg, SEED, CPU)
    return cfg, tr, poses, imgs, hr, params, buffers, weights


def _program(start: int, n_steps: int = 3):
    """The program's steps from the cell's start: losses, the first
    step's gradients by the reference's names, the parameters after, the
    draws, and the initial state."""
    cfg, tr, poses, imgs, hr, params, buffers, weights = _cell(start)
    p0, w0 = train_driver._clone(params), train_driver._clone(weights)
    P = joint_driver._program_setup(cfg, SEED, CPU, params, buffers, weights,
                                    poses, imgs, hr)
    steps = P["steps"]
    since0 = sr_trainer.steps_since_reset_at(cfg["train"]["pg_scale"],
                                             start - 1)
    out = {"losses": [], "draws": []}
    for i in range(n_steps):
        d = steps.draw(start + i, params, buffers)
        loss, _, _ = steps(start + i, since0 + i, params, buffers,
                           P["enc_opt"], P["sr_opt"], drawn=d)
        out["losses"].append(float(loss))
        out["draws"].append(d)
        if i == 0:
            g = train_driver._grad_from_moments(P["enc_opt"]["exp_avg"])
            sg = train_driver._grad_from_moments(
                P["sr_opt"]["exp_avg"]["srnet"])
            out["grads"] = {**dict(ref_train.leaves(g)),
                            **{"srnet." + joint_driver._raw_name(k): v
                               for k, v in ref_train.leaves(sg)}}
    out["params"] = {**dict(ref_train.leaves(params)),
                     **{"srnet." + k: v
                        for k, v in P["sr"].state_dict().items()}}
    out.update(cfg=cfg, tr=tr, poses=poses, imgs=imgs, hr=hr, p0=p0, w0=w0,
               buffers=buffers)
    return out


def _reference(prog):
    """The reference's steps on the program's draws (the benchmark's own
    call): losses, the first step's gradients and the parameters after."""
    out = joint_driver.reference_steps(
        prog["cfg"], prog["tr"], CPU, prog["p0"], prog["w0"], prog["buffers"],
        prog["poses"], prog["imgs"], prog["hr"],
        [d["patch"] for d in prog["draws"]])
    out["params"] = dict(ref_train.leaves(out["params"]))
    return out


@pytest.mark.parametrize("start,path", [(WINDOW_START, "window"),
                                        (SWEEP_START, "sweep")])
def test_steps_match_the_reference(start, path):
    prog = _program(start)
    assert {d["path"] for d in prog["draws"]} == {path}
    assert all(d["apply_tv"] == (path == "sweep") for d in prog["draws"])
    ref = _reference(prog)
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=1e-6)
    assert set(prog["grads"]) == set(ref["grads"])
    for k, want in ref["grads"].items():
        got = prog["grads"][k]
        tol = 2.0 ** -8 if k.startswith("rgbnet.") else 1e-5
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), (k, err)
    assert set(prog["params"]) == set(ref["params"])
    for k, want in ref["params"].items():
        off = int(((prog["params"][k] - want).abs() > 1e-6).sum())
        assert off <= 1e-4 * want.numel(), (k, off, want.numel())


def test_windowed_update_equals_the_full_grid_update():
    """The program's MaskedAdam on a grid window, with a masked gradient,
    equals the reference's over the whole grid bit for bit."""
    g = torch.Generator().manual_seed(4)
    grid = torch.randn((30, 28, 8, 3), generator=g)
    origin, win = (5, 9), (12, 10)
    sl = (slice(5, 17), slice(9, 19))
    steps = []
    for _ in range(3):
        gw = torch.randn(win + (8, 3), generator=g)
        gw[torch.rand(gw.shape, generator=g) < 0.5] = 0.0
        steps.append(gw)
    prog = {"k0": grid.clone()}
    opt = optim.init_state(prog)
    ref = {"k0": grid.clone()}
    ropt = ref_train.adam_init(ref)
    for i, gw in enumerate(steps):
        optim.apply_updates(prog, {"k0": gw}, opt, {"k0": 0.1 / (i + 1)},
                            skip_zero_grad={"k0"}, windows={"k0": origin})
        full = torch.zeros_like(grid)
        full[sl] = gw
        ref_train.adam_step(ref, {"k0": full}, ropt, {"k0": 0.1 / (i + 1)},
                            {"k0"})
    assert torch.equal(prog["k0"], ref["k0"])
    assert torch.equal(opt["exp_avg"]["k0"], ropt["m"]["k0"])
    assert torch.equal(opt["exp_avg_sq"]["k0"], ropt["v"]["k0"])
    assert not torch.equal(prog["k0"], grid)


def _gen_grad_off(monkeypatch):
    real = optim.apply_updates

    def apply(params, grads, *a, **k):
        if "srnet" in grads:
            leaf = grads["srnet"]["conv_first"]
            leaf["kernel"] = leaf["kernel"] * 1.01
        return real(params, grads, *a, **k)
    monkeypatch.setattr(optim, "apply_updates", apply)


def _window_update_skipped(monkeypatch):
    monkeypatch.setattr(optim, "_update_window", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [None, _gen_grad_off,
                                   _window_update_skipped],
                         ids=["sound", "generator_gradient_1pct_off",
                              "window_update_skipped"])
def test_the_comparison_catches_faults(monkeypatch, fault):
    """A sound run of the cell at toy sizes reads ``correct`` under the
    cell's limits; a generator gradient 1% off, or the grid window's update
    left out, does not."""
    monkeypatch.setattr(inputs, "config",
                        lambda name, read=inputs.config:
                        shrunk_joint(read, name))
    # this suite's conftest loads JAX for the parity tests; the run's guard
    # against JAX in the benchmark's own process does not apply here
    monkeypatch.setattr(run.Context, "check_modules",
                        staticmethod(lambda when: None))
    if fault is not None:
        fault(monkeypatch)
    r = run.run_cell(run.manifest(), CELL, SEED, 0.1, False, CPU,
                     on_chip=False)
    assert r["correct"] == (fault is None), r["checks"]
    assert set(r["checks"]) == set(judge.limits(CELL))


def _loop_args(**kw):
    return types.SimpleNamespace(**{
        **dict(seed=0, no_reload=True, no_reload_optimizer=False,
               ftdv_path="", ftsr_path="", i_print=0, i_val=0, i_weights=0,
               test_tile=0), **kw})


def test_loop_and_driver_loop_take_the_same_steps(tmp_path):
    """``scene_rep_reconstruction_sr_patch`` and a driver's loop over
    ``JointSteps`` from the same start on the same draws end with equal
    parameters, bit for bit (steps 1-4 with TV on the full-grid sweep,
    5-6 on the grid window)."""
    data = tiny_scene.sr_scene()
    box = tuple(np.array(v) for v in tiny_scene.SR_BOX)
    ov = tiny_scene.JOINT_OVERRIDES

    def cfg_of(n_iters, name):
        cfg = tconfig.load_config(os.path.join(
            ROOT, "fourk_nerf_torch", "configs", "llff",
            "fern_lg_joint_l1.py"))
        cfg = tiny_scene.apply_overrides(cfg, str(tmp_path), name, ov)
        cfg.fine_train.N_iters = n_iters
        return cfg

    def loop(n_iters, name):
        cfg = cfg_of(n_iters, name)
        return sr_trainer.scene_rep_reconstruction_sr_patch(
            _loop_args(), cfg, cfg.fine_model_and_render, cfg.fine_train,
            *box, data, stage="fine", device="cpu")

    _, mcfg, params, buffers, sr = loop(0, "start")
    _, _, want, _, want_sr = loop(ov["fine_train"]["N_iters"], "loop")

    cfg = cfg_of(ov["fine_train"]["N_iters"], "driver")
    ct = cfg.fine_train
    flat, _ = trainer.gather_training_rays(
        cfg, sr_trainer._force_image_sampler(ct), data, CPU)
    hr = torch.as_tensor(np.ascontiguousarray(
        sr_trainer._nhwc(data["srgt"])[data["i_train"]]))
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "rand_bkgd": False,
          "stepsize": float(cfg.fine_model_and_render.stepsize)}
    rk["ndc_planes"] = dmpigo.plane_aligned_ok(mcfg, rk["stepsize"], True)
    steps = sr_trainer.JointSteps(
        dmpigo, ct, cfg.fine_model_and_render, render_kwargs=rk, flat=flat,
        hr=hr, w2c=torch.as_tensor(data["w2c"][data["i_train"]]),
        sr_model=sr, patch=ct.N_patch, sr_ratio=4, seed=0)
    steps.rebuild(mcfg, params, buffers)
    enc_opt = optim.init_state(params)
    from fourk_nerf_torch import weights
    sr_opt = optim.init_state({"srnet": weights.sftnet_params(sr)})
    paths = []
    for gs in range(1, ct.N_iters + 1):
        paths.append(steps.draw(gs, params, buffers)["path"])
        steps(gs, gs - 1, params, buffers, enc_opt, sr_opt)
    assert paths == ["sweep"] * 4 + ["window"] * 2
    for k in ("density", "k0"):
        assert torch.equal(params[k], want[k]), k
    for k, v in params["rgbnet"].items():
        assert torch.equal(v, want["rgbnet"][k]), k
    got_sd, want_sd = sr.state_dict(), want_sr.state_dict()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


@pytest.mark.parametrize("start,path", [(WINDOW_START, "window"),
                                        (SWEEP_START, "sweep")])
def test_spans_nest_under_sr_step(start, path):
    """Off, a step records nothing; on, its spans nest under the root
    ``sr_step`` in order and ``sr.hr_pixels`` counts the decoded pixels."""
    cfg, tr, poses, imgs, hr, params, buffers, weights = _cell(start)
    P = joint_driver._program_setup(cfg, SEED, CPU, params, buffers, weights,
                                    poses, imgs, hr)

    def step(i):
        P["steps"](start + i, i, params, buffers, P["enc_opt"], P["sr_opt"])

    step(0)
    assert trace._records == [] and trace.summary()["counters"] == {}
    trace.enable()
    step(1)
    step(2)
    recs = trace._records
    roots = [r for r in recs if r.name == "sr_step"]
    assert len(roots) == 2 and all(r.parent is None and r.root == r.id
                                   for r in roots)
    want = ["sr.render", "sr.generator", "sr.backward"]
    want += ["sr.tv"] if path == "sweep" else []
    want += ["sr.update.encoder", "sr.update.generator"]
    for root in roots:
        kids = [r for r in recs if r.parent == root.id]
        assert [r.name for r in kids] == want
        assert all(r.root == root.id for r in kids)
    side = cfg["train"]["N_patch"] * cfg["decoder"]["scale"]
    assert trace.summary()["counters"]["sr.hr_pixels"] == 2 * side * side


@pytest.mark.parametrize("zeros", ["none", "scattered", "leading"])
def test_sweep_cumprod_gradient_is_torchs(zeros):
    """The sweep's transmittance product takes torch's own cumprod gradient
    bit for bit, with no zero factor, with several in a row, and with one
    first: its backward only leaves out torch's read-back of whether a
    factor is zero."""
    g = torch.Generator().manual_seed(4)
    x = torch.rand((16, 5, 40), generator=g)
    if zeros != "none":
        x[torch.rand(x.shape, generator=g) < 0.05] = 0.0
    if zeros == "leading":
        x[..., 0] = 0.0
    grad = torch.randn(x.shape, generator=g)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want, = torch.autograd.grad(torch.cumprod(a, -1), a, grad)
    out = plane_sweep._Cumprod.apply(b)
    got, = torch.autograd.grad(out, b, grad)
    assert torch.equal(out, torch.cumprod(x, -1))
    assert torch.equal(got, want)


def test_tree_update_takes_gradients_of_other_strides():
    """A gradient that comes channels-last, or with other strides on its
    size-1 axes, updates its leaf as its contiguous copy does, bit for
    bit, and the step size may be a 0-d tensor."""
    g = torch.Generator().manual_seed(5)

    def tree():
        return {"a": torch.randn((8, 3, 3, 3), generator=g),
                "b": {"w": torch.randn((8, 8, 1, 1), generator=g),
                      "bias": torch.randn((8,), generator=g)}}
    p, grads = tree(), tree()
    m, v = optim._zeros_like_tree(p), optim._zeros_like_tree(p)
    odd = {"a": grads["a"].to(memory_format=torch.channels_last),
           "b": {"w": grads["b"]["w"].as_strided((8, 8, 1, 1), (8, 1, 8, 8)),
                 "bias": grads["b"]["bias"]}}
    assert odd["a"].stride() != p["a"].stride()
    assert odd["b"]["w"].stride() != p["b"]["w"].stride()
    def clone(t):
        return ({k: clone(x) for k, x in t.items()} if isinstance(t, dict)
                else t.clone())
    p2, m2, v2 = (clone(t) for t in (p, m, v))
    optim._update_tree(p, grads, m, v, 1e-3)
    optim._update_tree(p2, odd, m2, v2, torch.tensor(1e-3))
    for path, leaf in optim._leaves(p):
        assert torch.equal(optim._at(p2, path), leaf), path
        assert torch.equal(optim._at(v2, path), optim._at(v, path)), path
