"""Port parity of the checkpoints: the npz format both ways (a file the
JAX package writes loads in the port, and the reverse, bitwise), the
background saver (it waits for every save, then raises the first
failure), and the import of the reference's torch ``.tar`` encoder
checkpoints."""

import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.train import checkpoints as jc, optim as jo
from fourk_nerf_torch import weights
from fourk_nerf_torch.train import checkpoints as tc, optim as to


def _state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"density": rng.normal(size=(4, 5, 3, 1)).astype(np.float32),
              "k0": rng.normal(size=(4, 5, 3, 6)).astype(np.float32),
              "rgbnet": {"w0": rng.normal(size=(12, 8)).astype(np.float32),
                         "b0": rng.normal(size=8).astype(np.float32)}}
    buffers = {"act_shift": rng.normal(size=(1, 1, 3, 1)).astype(np.float32),
               "mask_cache": rng.uniform(size=(4, 5, 3)) < 0.5}
    opt = {"exp_avg": jax.tree.map(lambda a: a * 0.5, params),
           "exp_avg_sq": jax.tree.map(lambda a: a * a, params), "step": 17}
    kwargs = {"xyz_min": [-1.0, -1.0, -1.0], "xyz_max": [1.0, 1.0, 1.0],
              "num_voxels": 60, "mpi_depth": 3}
    return kwargs, params, buffers, opt


def _assert_tree(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_tree(a[k], b[k], f"{path}/{k}")
        return
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)
    assert a.dtype == np.asarray(b).dtype, path


def test_jax_written_checkpoint_loads_in_the_port(tmp_path):
    kwargs, params, buffers, opt = _state()
    path = str(tmp_path / "fine_000017.npz")
    jopt = {**jax.tree.map(jnp.asarray, {k: opt[k] for k in
                                          ("exp_avg", "exp_avg_sq")}),
            "step": jnp.asarray(17, jnp.int32)}
    jc.save_checkpoint(path, kwargs, jax.tree.map(jnp.asarray, params),
                       jax.tree.map(jnp.asarray, buffers), jopt, 17,
                       extra_meta={"steps_since_reset": 5})
    kw, p, b, o, step, meta = tc.load_checkpoint(path, device="cpu")
    assert kw == kwargs and step == 17 and meta["steps_since_reset"] == 5
    _assert_tree(p, params)
    _assert_tree(b, buffers)
    assert o["step"] == 17
    _assert_tree(o["exp_avg"], opt["exp_avg"])
    _assert_tree(o["exp_avg_sq"], opt["exp_avg_sq"])
    # the port's optimizer takes the loaded state as its own
    fresh = to.init_state(p)
    assert to.restore_state(o, fresh) == (o, True)


@pytest.mark.parametrize("background", [False, True])
def test_port_written_checkpoint_loads_in_jax(tmp_path, background):
    kwargs, params, buffers, opt = _state(1)
    path = str(tmp_path / "fine_last.npz")
    topt = {**{k: weights.to_torch(opt[k], "cpu")
               for k in ("exp_avg", "exp_avg_sq")}, "step": 17}
    saver = tc.AsyncSaver() if background else None
    tp = weights.to_torch(params, "cpu")
    tc.save_checkpoint(path, kwargs, tp, weights.to_torch(buffers, "cpu"),
                       topt, 17, extra_meta={"steps_since_reset": 2},
                       saver=saver)
    if background:
        # the snapshot was taken at submit: a later in-place step does not
        # reach the file
        tp["density"].add_(1.0)
        saver.close()
    kw, p, b, o, step, meta = jc.load_checkpoint(path)
    assert kw == kwargs and step == 17 and meta["steps_since_reset"] == 2
    _assert_tree(p, params)
    _assert_tree(b, buffers)
    assert np.asarray(o["step"]).dtype == np.int32 and int(o["step"]) == 17
    _assert_tree(o["exp_avg"], opt["exp_avg"])
    assert jo.state_compatible(o, jo.init_state(p))
    assert not os.path.exists(path + ".tmp.npz")


def test_async_saver_waits_for_every_save_then_raises(tmp_path, monkeypatch):
    real = tc._write_npz
    gate = threading.Event()

    def write(path, flat):
        gate.wait(5)
        if "bad" in path:
            raise OSError("disk full")
        real(path, flat)

    monkeypatch.setattr(tc, "_write_npz", write)
    saver = tc.AsyncSaver()
    kwargs, params, buffers, _ = _state()
    tp, tb = weights.to_torch(params, "cpu"), weights.to_torch(buffers, "cpu")
    # queue the failing save and a good one behind it, without the
    # submit-side wait (which would raise at the second submit)
    monkeypatch.setattr(saver, "wait_for_pending_saves", lambda: None)
    tc.save_checkpoint(str(tmp_path / "bad.npz"), kwargs, tp, tb,
                       saver=saver)
    tc.save_checkpoint(str(tmp_path / "good.npz"), kwargs, tp, tb,
                       saver=saver)
    monkeypatch.undo()
    monkeypatch.setattr(tc, "_write_npz", write)
    gate.set()
    with pytest.raises(RuntimeError, match="1 of 2 saves failed") as e:
        saver.wait_for_pending_saves()
    assert isinstance(e.value.__cause__, OSError)
    # the save behind the failure landed before the error was raised
    assert os.path.isfile(tmp_path / "good.npz")
    saver.wait_for_pending_saves()  # nothing left
    saver.close()


def _reference_tar(path, seed=0):
    """A reference-layout encoder checkpoint written with torch.save."""
    rng = np.random.default_rng(seed)
    X, Y, Z = 4, 5, 3
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    sd = {"density.grid": t(rng.normal(size=(1, 1, X, Y, Z))),
          "k0.grid": t(rng.normal(size=(1, 6, X, Y, Z))),
          "act_shift.grid": t(rng.normal(size=(1, 1, 1, 1, Z))),
          "mask_cache.mask": torch.as_tensor(rng.uniform(size=(X, Y, Z))
                                             < 0.5),
          # Sequential(Linear, ReLU, Sequential(Linear, ReLU), Linear)
          "rgbnet.0.weight": t(rng.normal(size=(8, 12))),
          "rgbnet.0.bias": t(rng.normal(size=8)),
          "rgbnet.2.0.weight": t(rng.normal(size=(8, 8))),
          "rgbnet.2.0.bias": t(rng.normal(size=8)),
          "rgbnet.3.weight": t(rng.normal(size=(3, 8))),
          "rgbnet.3.bias": t(rng.normal(size=3))}
    torch.save({"global_step": 1234, "model_state_dict": sd,
                "model_kwargs": {"xyz_min": torch.tensor([-1.0, -1, -1]),
                                 "xyz_max": torch.tensor([1.0, 1, 1]),
                                 "num_voxels": X * Y * Z, "mpi_depth": Z}},
               path)


def test_import_torch_encoder_checkpoint_matches_jax(tmp_path):
    path = str(tmp_path / "fine_last.tar")
    _reference_tar(path)
    jkw, jp, jb, jstep = jc.import_torch_encoder_checkpoint(path)
    tkw, tp, tb, tstep = tc.import_torch_encoder_checkpoint(path)
    assert tkw == jkw and tstep == jstep == 1234
    _assert_tree(tp, jp)
    _assert_tree(tb, jb)
    assert tp["k0"].shape == (4, 5, 3, 6)
    assert [tp["rgbnet"][f"w{i}"].shape for i in range(3)] == \
        [(12, 8), (8, 8), (8, 3)]
