"""The joint cell (``fern_lg_joint.joint_l1``) on the CPU at toy sizes: its
mix against its driver, its readers, its yardstick against PyTorch's own
operation count, and ``correct`` on a sound run, on runs with a fault
planted in the program, and on the control."""

import copy
import functools

import pytest
import torch

from portbench import calibrate_joint, inputs, judge, run
from portbench.drivers import joint as joint_driver
from portbench.metrics import _joint_yardstick as J
from portbench.reference import common as C
from portbench.reference import sftnet

CPU = torch.device("cpu")
CELL = "fern_lg_joint.joint_l1"
SEED = 3_000_000_017
#: the joint configuration's toy sizes: the grid, frame, views and decoder
#: depth of ``tiny.TINY["fern_lg"]``, 8x8 patches
TOY = {"model": {"num_voxels": 90 * 100 * 64, "mpi_depth": 64},
       "camera": {"H": 72, "W": 96, "focal": 78.0},
       "decoder": {"num_block": 1}, "data": {"train_views": 2},
       "train": {"N_patch": 8}}
NEW_METRICS = ["render_ms.joint", "generator_ms.joint", "backward_ms.joint",
               "enc_update_ms.joint", "gen_update_ms.joint",
               "idle_share.joint", "joint_mfu"]


def shrunk_joint(read, name: str) -> dict:
    """``read(name)``, the joint configuration at its toy sizes."""
    c = copy.deepcopy(read(name))
    if name == "fern_lg_joint":
        for k, v in TOY.items():
            c[k].update(v)
    return c


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setattr(inputs, "config",
                        functools.partial(shrunk_joint, inputs.config))


def one_run(seed=SEED):
    return run.run_cell(run.manifest(), CELL, seed, 0.3, False, CPU,
                        on_chip=False)


def test_the_mix_holds_what_the_driver_reads():
    bench = run.manifest()
    tr = inputs.traffic(run.cell_of(bench, CELL)["traffic"])
    assert set(tr) == joint_driver.KEYS and tr["kind"] == "joint"
    ctx = run.Context("x", {}, {**tr, "clients": 8}, 1, 1.0, False, CPU,
                      False)
    with pytest.raises(ValueError, match="clients"):
        joint_driver.run(ctx)


def test_the_cell_reports_its_metrics():
    bench = run.manifest()
    e2e = [m["name"] for m in run.metrics_of(bench, CELL, False)]
    assert set(e2e) == {"step_ms", "setup_s"}
    layer = [m["name"] for m in run.metrics_of(bench, CELL, True)]
    assert set(layer) == set(NEW_METRICS)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_return_nothing_without_their_data(name):
    read = run.reader(name)
    assert read({"setup_s": 1.0, "config": inputs.config("fern_lg")}) is None
    assert read({"setup_s": 1.0, "config": inputs.config("fern_lg_joint"),
                 "steps": 10, "window_s": 1.0}) is None


@pytest.mark.parametrize("span", ["render", "generator", "backward",
                                  "update.encoder", "update.generator"])
def test_span_readers_read_per_step(monkeypatch, span):
    from fourk_nerf_torch.utils import trace
    name = {"update.encoder": "enc_update", "update.generator":
            "gen_update"}.get(span, span) + "_ms.joint"
    hand = {"spans": {f"sr.{span}": {"device_ms": 120.0}},
            "roots": {"sr_step": 12}, "counters": {}, "dropped": 0}
    monkeypatch.setattr(trace, "summary", lambda: hand)
    assert run.reader(name)({"profile": {}}) == pytest.approx(10.0)
    hand["roots"] = {"train_step": 12}
    assert run.reader(name)({"profile": {}}) is None


def test_mfu_reads_the_step_time():
    cfg = inputs.config("fern_lg_joint")
    rec = {"config": cfg, "steps": 10, "window_s": 1.0,
           "counts": {"weighted_per_step": 3e5}}
    flops = J.joint_step_flops(cfg, 3e5)
    assert run.reader("joint_mfu")(rec) == pytest.approx(
        100 * flops / 0.1 / 67e12)


def test_sftnet_count_equals_pytorchs():
    """The count of the decoder's forward and backward equals
    ``FlopCounterMode``'s over the reference decoder, the patch taking a
    gradient and the depth condition none, as in a joint step."""
    from torch.utils.flop_counter import FlopCounterMode
    dec = {"scale": 4, "num_feat": 16, "num_block": 1, "num_grow_ch": 8,
           "num_cond": 1}
    g = torch.Generator().manual_seed(0)
    w = {n: torch.randn(s, generator=g) * 0.1
         for n, s in sftnet.param_shapes(dec).items()}
    for t in w.values():
        t.requires_grad_(True)
    x = torch.rand(1, 6, 5, 3, generator=g, requires_grad=True)
    cond = torch.rand(1, 6, 5, 1, generator=g)
    with FlopCounterMode(display=False) as fc:
        sftnet.forward(w, dec, x, cond).sum().backward()
    assert fc.get_total_flops() == J.sftnet_train_flops(dec, 6, 5)


def test_sound_run_is_correct(toy):
    r = one_run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {"step_ms", "setup_s"}


def _gen_grad_off(monkeypatch):
    from fourk_nerf_torch.train import optim
    real = optim.apply_updates

    def apply(params, grads, *a, **k):
        if "srnet" in grads:
            leaf = grads["srnet"]["conv_first"]
            leaf["kernel"] = leaf["kernel"] * 1.01
        return real(params, grads, *a, **k)
    monkeypatch.setattr(optim, "apply_updates", apply)


def _window_update_skipped(monkeypatch):
    from fourk_nerf_torch.train import optim
    monkeypatch.setattr(optim, "_update_window", lambda *a, **k: None)


def _half_patch(monkeypatch):
    from fourk_nerf_torch.train import sr_trainer
    real = sr_trainer.SRTrainStep.loss

    def loss(self, out, batch):
        out = dict(out)
        n = out["rgb_feature"].shape[0]
        out["rgb_feature"] = torch.cat([out["rgb_feature"][:n // 2],
                                        out["rgb_feature"][n // 2:]
                                        .detach()])
        return real(self, out, batch)
    monkeypatch.setattr(sr_trainer.SRTrainStep, "loss", loss)


@pytest.mark.parametrize("fault", [_gen_grad_off, _window_update_skipped,
                                   _half_patch],
                         ids=["generator_gradient_1pct_off",
                              "window_update_skipped", "half_the_patch"])
def test_broken_step_is_not_correct(toy, monkeypatch, fault):
    fault(monkeypatch)
    r = one_run()
    assert not r["correct"], r["checks"]


def test_control_is_not_correct(toy):
    cfg = inputs.config("fern_lg_joint")
    tr = inputs.traffic("joint_l1")
    with C.full_fp32():
        nums = calibrate_joint.joint_control(cfg, tr, SEED, CPU)
    lim = judge.limits(CELL)
    for what, n in nums.items():
        ok, checks = judge.verdict(n, lim)
        assert not ok, (what, checks)
