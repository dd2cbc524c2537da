"""``correct`` at small sizes on the CPU, with each cell's committed
limits: every cell's run reads correct;
the same run with its timed path broken underneath reads not correct,
once for each fault the cell can have; so does the control (the
reference one precision below the configuration's, in the program's
place). The harness's look for a chip is skipped (a CPU device); the rest
of the run is the run."""

import pytest
import torch

from portbench import calibrate, inputs, judge, run
from portbench.tests.tiny import SEED, tiny  # noqa: F401

CPU = torch.device("cpu")
CELLS = ["fern_lg.render_4k", "chair_syn.flythrough", "fern_lg.pretrain",
         "chair_syn.train_fine"]
RENDER, TRAIN = CELLS[:2], CELLS[2:]


def one_run(workload, seed=SEED):
    return run.run_cell(run.manifest(), workload, seed, 0.3, False, CPU,
                        on_chip=False)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    r = one_run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"setup_s"}


def _half_rays(monkeypatch):
    from fourk_nerf_torch import pipeline
    real = pipeline.FramePipeline.encode

    def encode(self, H, W, K, c2w):
        enc = dict(real(self, H, W, K, c2w))
        for k in ("rgb_feature", "depth"):
            enc[k] = enc[k].clone()
            enc[k][H // 2:] = 0
        return enc
    monkeypatch.setattr(pipeline.FramePipeline, "encode", encode)


def _altered_colour(monkeypatch):
    from fourk_nerf_torch import pipeline
    real = pipeline.FramePipeline.encode

    def encode(self, H, W, K, c2w):
        enc = dict(real(self, H, W, K, c2w))
        enc["rgb_feature"] = enc["rgb_feature"] + 0.05
        return enc
    monkeypatch.setattr(pipeline.FramePipeline, "encode", encode)


@pytest.mark.parametrize("workload", RENDER)
@pytest.mark.parametrize("fault", [_half_rays, _altered_colour],
                         ids=["half_the_rays", "answer_altered"])
def test_broken_frame_is_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    r = one_run(workload)
    assert not r["correct"], r["checks"]


def _state_unchanged(monkeypatch):
    from fourk_nerf_torch.train import optim
    monkeypatch.setattr(optim, "apply_updates", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from fourk_nerf_torch.train import trainer
    real = trainer.TrainStep._loss_grads_state

    def half(self, params, buffers, batch, groups, bg_noise):
        h = batch[0].shape[0] // 2
        return real(self, params, buffers, tuple(x[:h] for x in batch),
                    groups, None if bg_noise is None else bg_noise[:h])
    monkeypatch.setattr(trainer.TrainStep, "_loss_grads_state", half)


def _gradient_altered(monkeypatch):
    from fourk_nerf_torch.train import optim
    real = optim.apply_updates

    def apply(params, grads, *a, **k):
        grads["rgbnet"]["w0"] = grads["rgbnet"]["w0"] * 1.01
        return real(params, grads, *a, **k)
    monkeypatch.setattr(optim, "apply_updates", apply)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _gradient_altered],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_broken_step_is_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    r = one_run(workload)
    assert not r["correct"], r["checks"]


def _tv_left_out(monkeypatch):
    from fourk_nerf_torch.train import trainer
    real = trainer.TrainStep.__call__

    def call(self, *a, **k):
        return real(self, *a, **{**k, "apply_tv": False})
    monkeypatch.setattr(trainer.TrainStep, "__call__", call)


def test_step_without_tv_is_not_correct(tiny, monkeypatch):
    """The pretrain cell trains with TV; a step that leaves it out fails."""
    _tv_left_out(monkeypatch)
    r = one_run("fern_lg.pretrain")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, workload):
    bench = run.manifest()
    cell = run.cell_of(bench, workload)
    cfg, tr = inputs.config(cell["config"]), inputs.traffic(cell["traffic"])
    if tr["kind"] == "render":
        nums = calibrate.render_control(cfg, tr, SEED, CPU)
    else:
        nums = calibrate.train_control(cfg, tr, SEED, CPU)["control"]
    ok, checks = judge.verdict(nums, judge.limits(workload))
    assert not ok, checks


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    """A short run of each cell at its full size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    r = run.run_cell(run.manifest(), workload, SEED, 2.0, False, dev,
                     on_chip=True)
    assert r["correct"], r["checks"]
