"""Port parity: fourk_nerf_torch.train.optim (MaskedAdam in place) vs the
JAX package's functional ``optim.apply_updates`` on identical params,
gradients and state, drawn with numpy. Tolerance: 1e-6 absolute on the
params and moments after three steps (the update is float32 in both; the
order of a few products differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict as JConfigDict
from fourk_nerf_tpu.train import optim as jo
from fourk_nerf_torch import weights
from fourk_nerf_torch.train import optim as to

TOL = 1e-6


def _tree(rng, zero_frac=0.0):
    def arr(shape):
        a = rng.normal(size=shape).astype(np.float32)
        if zero_frac:
            a[rng.uniform(size=shape) < zero_frac] = 0.0
        return a

    return {"density": arr((5, 4, 3, 1)), "k0": arr((5, 4, 3, 6)),
            "rgbnet": {"w0": arr((9, 8)), "b0": arr((8,)),
                       "w1": arr((8, 3)), "b1": arr((3,))}}


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                      else tree)


def _assert_close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_close(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=path)


@pytest.mark.parametrize("mode", ["plain", "skip_zero_grad", "per_lr",
                                  "frozen"])
def test_apply_updates_matches_jax(mode):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    lrs = {"density": 0.1, "k0": 0.05, "rgbnet": 1e-3}
    skip = frozenset({"density", "k0"}) if mode == "skip_zero_grad" \
        else frozenset()
    if mode == "frozen":
        lrs.pop("k0")
    per_lr = ({"density": rng.uniform(size=(5, 4, 3, 1)).astype(np.float32)}
              if mode == "per_lr" else None)
    jp, js = _jax(params), jo.init_state(_jax(params))
    tp = weights.to_torch(params, "cpu")
    ts = to.init_state(tp)
    tplr = weights.to_torch(per_lr, "cpu") if per_lr else None
    for _ in range(3):
        # exact zeros in the gradients: skipped entries in the masked mode
        g = _tree(rng, zero_frac=0.3)
        jp, js = jo.apply_updates(jp, _jax(g), js, lrs, skip_zero_grad=skip,
                                  per_lr=_jax(per_lr) if per_lr else None)
        to.apply_updates(tp, weights.to_torch(g, "cpu"), ts, lrs,
                         skip_zero_grad=skip, per_lr=tplr)
    _assert_close(_np(tp), _np(jp), "params")
    _assert_close(_np(ts["exp_avg"]), _np(js["exp_avg"]), "exp_avg")
    _assert_close(_np(ts["exp_avg_sq"]), _np(js["exp_avg_sq"]), "exp_avg_sq")
    assert ts["step"] == int(js["step"]) == 3
    if mode == "frozen":
        np.testing.assert_array_equal(_np(tp["k0"]), params["k0"])


def test_apply_updates_in_place_across_chunks(monkeypatch):
    # an update split over several in-place chunks equals the one-chunk
    # update bitwise, and the param tensors stay the same objects
    rng = np.random.default_rng(1)
    params = _tree(rng)
    g = _tree(rng, zero_frac=0.3)
    out = []
    for chunk in (1 << 24, 7):
        monkeypatch.setattr(to, "_CHUNK", chunk)
        tp = weights.to_torch(params, "cpu")
        ids = {k: id(v) for k, v in tp.items() if k != "rgbnet"}
        ts = to.init_state(tp)
        to.apply_updates(tp, weights.to_torch(g, "cpu"), ts,
                         {"density": 0.1, "k0": 0.1, "rgbnet": 1e-3},
                         skip_zero_grad=frozenset({"density", "k0"}))
        assert {k: id(v) for k, v in tp.items() if k != "rgbnet"} == ids
        out.append(_np(tp))
    for k in ("density", "k0"):
        np.testing.assert_array_equal(out[0][k], out[1][k])


def test_state_from_jax_numpy_layout_continues_the_same():
    # a JAX-layout state (numpy, int32 step) carried into the port gives
    # the next step of the JAX update
    rng = np.random.default_rng(2)
    params = _tree(rng)
    lrs = {"density": 0.1, "k0": 0.1, "rgbnet": 1e-3}
    jp, js = jo.apply_updates(_jax(params), _jax(_tree(rng)),
                              jo.init_state(_jax(params)), lrs)
    g = _tree(rng)
    jp2, js2 = jo.apply_updates(jp, _jax(g), js, lrs)
    ts = weights.opt_state_from_numpy(
        {"exp_avg": _np(js["exp_avg"]), "exp_avg_sq": _np(js["exp_avg_sq"]),
         "step": np.asarray(js["step"], np.int32)}, device="cpu")
    assert ts["step"] == 1
    tp = weights.to_torch(_np(jp), "cpu")
    to.apply_updates(tp, weights.to_torch(g, "cpu"), ts, lrs)
    _assert_close(_np(tp), _np(jp2))


@pytest.mark.parametrize("steps", [0, 1, 1234])
def test_group_lr_matches_jax(steps):
    assert to.group_lr(0.1, steps, 20) == pytest.approx(
        float(jo.group_lr(0.1, steps, 20)), rel=1e-12)


def test_build_group_lrs_matches_jax():
    cfg = JConfigDict(lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3,
                      lrate_srnet=0, lrate_adainet=1e-3, N_iters=5)
    params = {"density": 0, "k0": 0, "rgbnet": {}}
    assert to.build_group_lrs(cfg, params) == jo.build_group_lrs(cfg, params)
    assert to.build_group_lrs(cfg, params) == {"density": 0.1, "k0": 0.1,
                                               "rgbnet": 1e-3}


def test_restore_state_matches_jax():
    rng = np.random.default_rng(3)
    params = _tree(rng)
    fresh_t = to.init_state(weights.to_torch(params, "cpu"))
    fresh_j = jo.init_state(_jax(params))
    loaded = to.init_state(weights.to_torch(params, "cpu"))
    loaded["step"] = 7
    state, ok = to.restore_state(loaded, fresh_t)
    assert ok and state is loaded
    assert jo.restore_state(fresh_j, fresh_j)[1]
    # a stale shape (another pg_scale phase) and None are refused, as in JAX
    stale = to.init_state(weights.to_torch(
        {**params, "k0": np.zeros((3, 3, 3, 6), np.float32)}, "cpu"))
    assert to.restore_state(stale, fresh_t) == (fresh_t, False)
    assert to.restore_state(None, fresh_t) == (fresh_t, False)
    assert not to.state_compatible(stale, fresh_t)
    assert not jo.state_compatible(
        jo.init_state(_jax({**params, "k0": np.zeros((3, 3, 3, 6))})),
        fresh_j)
