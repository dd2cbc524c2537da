"""The joint CLI of the port, ``fourk_nerf_torch.run_sr``, on the CPU: it
trains a few joint steps on a tiny LLFF scene written to disk (the LR
views at ``images_4``, the x4 ground truth at ``images``), reloads the
final joint checkpoint with ``--render_only`` and scores the test views
as the trained model did, then renders a one-frame fly-through with
``--render_video``."""

import os
import sys

import numpy as np
import pytest

from fourk_nerf_torch import config as tconfig, run_sr

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    from test_torch_config_data import _write_llff_scene

    tmp = tmp_path_factory.mktemp("sr_cli")
    scene = tmp / "scene"
    _write_llff_scene(str(scene), n=5, h=12, w=16)
    cfg = tmp / "tiny_joint.py"
    cfg.write_text(
        f"_base_ = {os.path.join(ROOT, 'fourk_nerf_torch', 'configs', 'llff', 'fern_lg_joint_l1.py')!r}\n"
        f"expname = 'cli'\nbasedir = {str(tmp / 'logs')!r}\n"
        f"data = dict(datadir={str(scene)!r}, llffhold=2, width=None, "
        "height=None, rand_bkgd=False)\n"
        "fine_train = dict(N_iters=4, N_patch=4, pg_scale=[], "
        "tv_before=3)\n"
        "fine_model_and_render = dict(num_voxels=16 * 16 * 8, mpi_depth=8, "
        "rgbnet_width=16, fast_color_thres=1.0 / 8 / 5)\n")
    base = ["--config", str(cfg), "--device", "cpu", "--i_print", "2",
            "--i_val", "0", "--i_weights", "2"]
    trained = run_sr.main(base + ["--render_test", "--dump_images"])
    return {"cfg": str(cfg), "base": base, "trained": trained,
            "rundir": tmp / "logs" / "cli"}


def test_run_sr_trains_and_scores(tiny_run, capsys):
    rundir = tiny_run["rundir"]
    assert (rundir / "fine_last.npz").is_file()
    assert sorted(os.listdir(rundir / "ckpt_saved")) == [
        "fine_000002.npz", "fine_000004.npz"]
    test = tiny_run["trained"]["test"]
    assert np.isfinite(test["psnr_sr"]) and len(test["sr_frames"]) == 3
    assert tuple(test["sr_frames"][0].shape) == (48, 64, 3)
    assert sorted(os.listdir(rundir / "render_test_sr")) == [
        "sr_000.png", "sr_001.png", "sr_002.png"]


def test_render_only_reloads_and_scores_the_same(tiny_run):
    again = run_sr.main(tiny_run["base"] + ["--render_only"])
    a, b = tiny_run["trained"]["test"], again["test"]
    assert a["psnr_sr"] == b["psnr_sr"] and a["psnr_lr"] == b["psnr_lr"]
    for x, y in zip(a["sr_frames"], b["sr_frames"]):
        assert bool((x == y).all())


def test_render_video_decodes_the_trained_generator(tiny_run):
    args = run_sr.config_parser().parse_args(
        tiny_run["base"] + ["--render_only", "--render_video"])
    cfg = tconfig.load_config(tiny_run["cfg"])
    data = run_sr.load_everything(args, cfg)
    data["render_poses"] = data["render_poses"][:1]
    res = run_sr.run(args, cfg, data)
    frames = res["video"]["frames"]
    assert tuple(frames.shape) == (1, 48, 64, 3)
    assert bool(((frames >= 0) & (frames <= 1)).all())
    assert os.listdir(tiny_run["rundir"] / "render_video_sr")


@pytest.mark.parametrize("flag", ["--render_video", "--dump_images"])
def test_writes_without_imageio_fail_before_training(tiny_run, monkeypatch,
                                                     flag):
    from fourk_nerf_torch.train import sr_trainer

    def no_training(*a, **k):
        raise AssertionError("trained before checking for imageio")

    args = run_sr.config_parser().parse_args(
        tiny_run["base"] + ["--render_test", flag])
    cfg = tconfig.load_config(tiny_run["cfg"])
    data = run_sr.load_everything(args, cfg)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setattr(sr_trainer, "train_sr", no_training)
    with pytest.raises(SystemExit, match="imageio"):
        run_sr.run(args, cfg, data)
