"""The stage lifecycle and the step core that both training loops
(``trainer.scene_rep_reconstruction`` and
``sr_trainer.scene_rep_reconstruction_sr_patch``) share: each loop's
checkpoint search, the lr clock and the TV schedule across a resume, an
:class:`~fourk_nerf_torch.train.trainer.EncoderStage` resumed before, at
and after a ``pg_scale`` boundary, and the gradient helper's zero fill.
CPU, no JAX."""

import os
import types

import pytest
import torch

from fourk_nerf_torch import config as tconfig
from fourk_nerf_torch.config import ConfigDict
from fourk_nerf_torch.models import dmpigo
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import checkpoints, sr_trainer, trainer

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: each loop's search: its explicit-path flag and the directory of its
#: periodic files under the run directory
LOOPS = {"run": (trainer.find_reload_path, "ft_path", ""),
         "run_sr": (sr_trainer.find_reload_path, "ftdv_path", "ckpt_saved")}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_find_reload_path(tmp_path, loop):
    find, flag, sub = LOOPS[loop]
    rundir = tmp_path / "run"
    periodic, other = rundir / sub, rundir / ("" if sub else "ckpt_saved")
    periodic.mkdir(parents=True)
    other.mkdir(exist_ok=True)
    for name in ("fine_999999.npz", "fine_1000000.npz", "fine_000010.npz",
                 "fine_2000000.npz.tmp.npz", "best_psnr.npz",
                 "coarse_3000000.npz"):
        (periodic / name).write_bytes(b"")
    (other / "fine_3000000.npz").write_bytes(b"")  # the other loop's file
    # the other loop's flag is not this loop's
    args = types.SimpleNamespace(
        no_reload=False, **{flag: "", ("ftdv_path" if flag == "ft_path"
                                       else "ft_path"): "/other/x.npz"})
    # the largest parsed step, not the lexicographic largest
    assert find(args, str(rundir), "fine") == \
        str(periodic / "fine_1000000.npz")
    (rundir / "fine_last.npz").write_bytes(b"")
    assert find(args, str(rundir), "fine") == str(rundir / "fine_last.npz")
    setattr(args, flag, "/elsewhere/pretrain.npz")
    assert find(args, str(rundir), "fine") == "/elsewhere/pretrain.npz"
    args.no_reload = True
    assert find(args, str(rundir), "fine") is None


SCHEDULE = ConfigDict(pg_scale=[1000, 2000], tv_after=500, tv_before=1500,
                      tv_every=10, tv_dense_before=800)


@pytest.mark.parametrize("start, since, step, tv", [
    (0, 0, 10, (False, True)),
    (640, 640, 650, (True, True)),
    (704, 704, 714, (False, True)),
    (999, 999, 1000, (True, False)),
    (1000, 0, 1010, (True, False)),
    (1500, 500, 1510, (False, False)),
    (2500, 500, 2510, (False, False)),
], ids=["fresh_before_tv", "dense_tv", "off_tv_every", "before_boundary",
        "at_boundary", "after_boundary_past_tv", "after_last_boundary"])
def test_stage_schedule(start, since, step, tv):
    """A run resumed after ``start`` from a file without its clock: the lr
    clock it starts from, and the TV switches of its step ``step``, as
    both loops read them (the joint loop through ``sr_trainer``'s name and
    ``JointSteps.draw``)."""
    assert sr_trainer.steps_since_reset_at is trainer.steps_since_reset_at
    assert trainer.steps_since_reset_at(SCHEDULE.pg_scale, start) == since
    assert trainer.tv_schedule(SCHEDULE, step) == tv


def _tiny_stage(tmp_path, reload_path=None):
    cfg = tiny_scene.apply_overrides(tconfig.load_config(os.path.join(
        ROOT, "fourk_nerf_torch", "configs", "llff", "fern_lg_pretrain.py")),
        str(tmp_path))
    data = tiny_scene.scene()
    xyz = trainer.compute_bbox_by_cam_frustrm(
        cfg, data["HW"], data["Ks"], data["poses"], data["i_train"],
        data["near"], data["far"], device="cpu")
    return cfg, trainer.EncoderStage(
        dmpigo, cfg, cfg.fine_model_and_render, cfg.fine_train, *xyz, data,
        reload_path=reload_path, coarse_ckpt_path=None, seed=0, device="cpu")


@pytest.mark.parametrize("start", [3, 5, 7])
def test_encoder_stage_resumes_across_a_boundary(tmp_path, start):
    """A stage reloaded from a file at ``start`` (no clock kept in it) takes
    the clock of the last boundary (``pg_scale`` [5]), and its steps to 10
    scale the grid at 5 only, with fresh moments and the clock reset."""
    cfg, new = _tiny_stage(tmp_path)
    assert new.since_reset == 0 and new.start == 0
    path = str(tmp_path / "at.npz")
    checkpoints.save_checkpoint(path, dmpigo.get_kwargs(new.model_cfg),
                                new.params, new.buffers, global_step=start)
    _, st = _tiny_stage(tmp_path, path)
    assert st.start == start and st.meta.get("global_step") == start
    assert st.since_reset == trainer.steps_since_reset_at([5], start)
    assert st.render_kwargs == trainer.stage_render_kwargs(
        dmpigo, st.model_cfg, cfg, cfg.fine_model_and_render,
        tiny_scene.scene())
    st.opt = "moments of the old grid"
    size0 = tuple(st.model_cfg.world_size)
    for global_step in range(start + 1, 11):
        scaled = st.advance(global_step)
        assert scaled == (global_step == 5)
        if scaled:
            assert st.since_reset == 0 and st.opt["step"] == 0
            assert tuple(st.opt["exp_avg"]["density"].shape) == \
                tuple(st.params["density"].shape)
            assert tuple(st.model_cfg.world_size) != size0
        st.since_reset += 1
    since0 = trainer.steps_since_reset_at([5], start)
    assert st.since_reset == (10 - 5 + 1 if start < 5 else
                              since0 + 10 - start)


def test_tree_grads_zero_fills_unused_leaves():
    """The gradients come in the layout of each tree given; a leaf the
    loss does not reach gets zeros of its shape, not None."""
    g = torch.Generator().manual_seed(0)
    params = {"density": torch.randn(3, 4, 1, generator=g),
              "rgbnet": {"w0": torch.randn(4, 2, generator=g),
                         "b0": torch.randn(2, generator=g)},
              "k0": torch.randn(3, 4, 2, generator=g)}
    extra = {"srnet": {"kernel": torch.randn(2, 2, generator=g)}}
    live = trainer.live_groups(params, ["density", "rgbnet"])
    extra = trainer.live_groups(extra, ["srnet"])
    assert set(live) == {"density", "rgbnet"}
    assert all(x.requires_grad for x in (live["density"],
                                         live["rgbnet"]["w0"]))
    loss = (live["density"] ** 2).sum() + live["rgbnet"]["w0"].sum()
    grads, extra_grads = trainer.tree_grads(loss, live, extra)
    assert torch.equal(grads["density"], 2 * params["density"])
    assert torch.equal(grads["rgbnet"]["w0"], torch.ones(4, 2))
    assert torch.equal(grads["rgbnet"]["b0"], torch.zeros(2))
    assert torch.equal(extra_grads["srnet"]["kernel"], torch.zeros(2, 2))
    assert list(grads) == ["density", "rgbnet"]
    assert list(grads["rgbnet"]) == ["w0", "b0"]
