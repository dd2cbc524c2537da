"""Port parity of the joint trainer's loop and files: the JAX package's
``scene_rep_reconstruction_sr_patch`` trains ``fern_lg_joint_l1`` (cut to
a tiny NDC scene by ``tools/tiny_scene.py``: a 64x64x16 grid, 8-pixel
patches, the published SFTNet of 5 RRDBs) for 6 steps with a periodic
checkpoint every 3; the port
resumes from the JAX-written ``ckpt_saved/fine_000003.npz`` and runs steps
4-6. TV is on through step 4 (the full-grid sweep step) and off after (the
grid-window step).

Tolerances: the losses at each print within 1e-4 relative; the final
checkpoints' params and moments: under 1e-3 of all entries off by more
than 1e-4 (the first moves of MaskedAdam are ``lr * sign(g)``, and the
sweep's bfloat16 gradients may flip the sign of one within rounding of
zero), and in each array the distance to JAX's under 5% of the distance
JAX's array moved over the resumed steps 4-6, so that a stale leaf fails.
(A count per array does not hold: the grid's gradients are of bfloat16
grade relative to their largest entry, and Adam's normalisation turns
that into an error of ~1% of the move on the density entries whose
gradient is ~1% of the largest; at lr 0.1 over three steps ~0.7% of the
density entries are off by more than 1e-4.) The port's files load in the JAX package's ``load_joint`` with
every array equal."""

import os
import types

import numpy as np
import pytest

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.train import checkpoints as jc, sr_trainer as jst
from fourk_nerf_torch import config as tconfig
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import sr_trainer as tst

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "llff", "fern_lg_joint_l1.py")
N_ITERS = tiny_scene.JOINT_OVERRIDES["fine_train"]["N_iters"]
I_WEIGHTS = 3


def cut_config(cfg, basedir, expname):
    return tiny_scene.apply_overrides(cfg, basedir, expname,
                                      tiny_scene.JOINT_OVERRIDES)


def args(**kw):
    base = dict(seed=0, no_reload=False, no_reload_optimizer=False,
                ftdv_path="", ftsr_path="", i_print=1, i_val=0,
                i_weights=I_WEIGHTS, test_tile=0)
    return types.SimpleNamespace(**{**base, **kw})


class Recorder:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def by_step(self):
        out = {}
        for tag, v, step in self.rows:
            out.setdefault(step, {})[tag] = v
        return out


def _box():
    return tuple(np.array(v) for v in tiny_scene.SR_BOX)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sr_loop")
    data = tiny_scene.sr_scene()
    jcfg = cut_config(jconfig.load_config(os.path.join(ROOT, "fourk_nerf_tpu",
                                                       CFG)),
                      str(tmp / "jax"), "joint")
    jw = Recorder()
    jst.scene_rep_reconstruction_sr_patch(
        args(no_reload=True), jcfg, jcfg.fine_model_and_render,
        jcfg.fine_train, *_box(), data, stage="fine", writer=jw)
    jst_dir = os.path.join(jcfg.basedir, jcfg.expname)
    tcfg = cut_config(tconfig.load_config(
        os.path.join(ROOT, "fourk_nerf_torch", CFG)), str(tmp / "torch"),
        "joint")
    tw = Recorder()
    tst.scene_rep_reconstruction_sr_patch(
        args(ftdv_path=os.path.join(jst_dir, "ckpt_saved",
                                    "fine_000003.npz")),
        tcfg, tcfg.fine_model_and_render, tcfg.fine_train, *_box(), data,
        stage="fine", writer=tw, device="cpu")
    return dict(jax_dir=jst_dir, torch_dir=os.path.join(tcfg.basedir,
                                                        tcfg.expname),
                jax=jw.by_step(), torch=tw.by_step())


def test_resumed_losses_match_jax(runs):
    assert sorted(runs["torch"]) == [4, 5, 6]
    for step, got in runs["torch"].items():
        want = runs["jax"][step]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                       err_msg=f"{k} at {step}")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def test_final_checkpoint_matches_jax(runs):
    got = _npz(os.path.join(runs["torch_dir"], "fine_last.npz"))
    want = _npz(os.path.join(runs["jax_dir"], "fine_last.npz"))
    assert set(got) == set(want)
    start = _npz(os.path.join(runs["jax_dir"], "ckpt_saved",
                              f"fine_{I_WEIGHTS:06d}.npz"))
    off = total = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k.endswith("/step") or w.dtype == bool:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        off += int(np.sum(np.abs(got[k] - w) > 1e-4))
        total += w.size
        # every leaf takes JAX's move over the resumed steps: a leaf left
        # stale would be off by the whole move
        moved = np.linalg.norm((w - start[k]).astype(np.float64))
        err = np.linalg.norm((got[k] - w).astype(np.float64))
        assert err <= 0.05 * moved if moved else err <= 1e-4, (k, err, moved)
    assert off < 1e-3 * total, (off, total)
    assert int(got["opt/enc/step"]) == int(got["opt/sr/step"]) == N_ITERS


@pytest.mark.parametrize("name", ["fine_last.npz",
                                  os.path.join("ckpt_saved",
                                               "fine_000006.npz")])
def test_port_joint_files_load_in_jax(runs, name):
    path = os.path.join(runs["torch_dir"], name)
    _, _, params, buffers, sr_params, d, _, step = jst.load_joint(path,
                                                                 ndc=True)
    assert step == N_ITERS and d is None
    raw = _npz(path)
    flat = {f"params/{k}": v for k, v in
            jc.common.tree_to_flat_dict(params).items()}
    flat.update({f"params/__sr__/{k}": v for k, v in
                 jc.common.tree_to_flat_dict(sr_params).items()})
    flat.update({f"buffers/{k}": v for k, v in
                 jc.common.tree_to_flat_dict(buffers).items()})
    _, _, _, opt, _, meta = jc.load_checkpoint(path)
    flat.update({f"opt/{k}": v for k, v in
                 jc.common.tree_to_flat_dict(opt).items()})
    assert set(flat) == set(raw)
    for k, v in raw.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    assert meta["pipeline"] == "joint_sr" and meta["steps_since_reset"] == 6
    # and in the port: the generator's moments in the module's layout
    *_, tsr, topt, tstep, _ = tst.load_joint(path, True, "cpu")
    assert tstep == N_ITERS and topt["enc"]["step"] == N_ITERS
    np.testing.assert_array_equal(
        tsr["conv_first"]["kernel"].numpy(),
        raw["params/__sr__/conv_first/kernel"])
    np.testing.assert_array_equal(
        topt["sr"]["exp_avg"]["srnet"]["conv_first"]["kernel"].numpy(),
        raw["opt/sr/exp_avg/srnet/conv_first/kernel"].transpose(3, 2, 0, 1))
