"""The encoder's grid update on the CPU: the in-place TV entry points
(``common.grid_tv_add_``, ``trainer.add_tv_``, ``TrainStep.add_tv``,
``SRTrainStep.add_tv``) against the plain TV gradient added after, and
MaskedAdam's ``update.touched`` / ``update.entries`` counters. The kernels
themselves (``ops/cuda_grid.py``) run only on the card:
``tests/test_torch_gpu.py`` holds them against these plain versions."""

import types

import pytest
import torch

from fourk_nerf_torch.config import ConfigDict
from fourk_nerf_torch.models import common, dcvgo, dmpigo, dvgo, dvqgo
from fourk_nerf_torch.ops import cuda_grid, render, tensorf
from fourk_nerf_torch.train import optim, sr_trainer, trainer
from fourk_nerf_torch.utils import trace

TENSORF = dict(density_type="TensoRFGrid", k0_type="TensoRFGrid",
               density_config={"n_comp": 2}, k0_config={"n_comp": 3})


def _bits(t):
    return t.contiguous().view(torch.int32)


def _grad_like(grid, zero_share, seed):
    """A gradient of ``grid``'s shape, zero on ``zero_share`` of the entries,
    with some ``-0.0`` among the zeros."""
    g = torch.Generator().manual_seed(seed)
    out = torch.randn(grid.shape, generator=g) * 1e-3
    r = torch.rand(grid.shape, generator=g)
    out[r < zero_share] = 0.0
    out[r < zero_share / 3] = -0.0
    return out


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 1, 3), (3, 1, 2, 9),
                                   (5, 4, 7, 12), (1, 6, 5, 1)])
@pytest.mark.parametrize("dense", [False, True])
def test_grid_tv_add_matches_plain_bitwise(shape, dense):
    """A dense grid on the CPU: ``grad += total_variation_grad(...)``, bit
    for bit, sparse mode masked by the gradient before the add."""
    g = torch.Generator().manual_seed(1)
    grid = torch.randn(shape, generator=g) * 2.0  # some differences clip
    grad = _grad_like(grid, 0.6, 2)
    want = grad + render.total_variation_grad(grid, 0.3, 0.5, 0.7,
                                              None if dense else grad)
    got = grad.clone()
    common.grid_tv_add_("DenseGrid", grid, got, 0.3, 0.5, 0.7, dense)
    assert torch.equal(_bits(got), _bits(want))
    if not dense:  # a zero gradient gets nothing
        assert not bool(got[grad == 0].any())


def test_grid_tv_add_tensorf_factors():
    """TensoRF factors: each factor's gradient plus its autograd TV
    gradient (factors have no sparse mode), in place."""
    g = torch.Generator().manual_seed(4)
    fac = common.grid_init("TensoRFGrid", 3, (5, 6, 4), (("n_comp", 2),),
                           generator=g, device="cpu")
    grad = {k: torch.randn(v.shape, generator=g) for k, v in fac.items()}
    tv = tensorf.tensorf_tv_grad(fac, 0.2, 0.3, 0.4)
    got = {k: v.clone() for k, v in grad.items()}
    for dense in (True, False):
        common.grid_tv_add_("TensoRFGrid", fac, got, 0.2, 0.3, 0.4, dense)
    for k in grad:
        assert torch.equal(_bits(got[k]), _bits(grad[k] + tv[k] + tv[k])), k


def _dmpigo(grid_kw=None):
    cfg = dmpigo.make_config(xyz_min=[-1.3, -1.2, -1.0],
                             xyz_max=[1.3, 1.2, 1.0], num_voxels=8 * 8 * 4,
                             mpi_depth=4, rgbnet_dim=3, rgbnet_width=8,
                             **(grid_kw or {}))
    params, _ = dmpigo.init(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _dvgo(grid_kw=None):
    cfg = dvgo.make_config(xyz_min=[-1.0, -0.8, -0.6],
                           xyz_max=[1.0, 0.9, 0.7], num_voxels=7 * 6 * 5,
                           num_voxels_base=7 * 6 * 5, alpha_init=1e-2,
                           rgbnet_dim=3, rgbnet_width=8, **(grid_kw or {}))
    params, _ = dvgo.init(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    return cfg, params


def _filled(params, seed):
    """The params with random dense grids, and gradients for the grids (60%
    zeros in a dense grid's)."""
    g = torch.Generator().manual_seed(seed)
    params = dict(params)
    grads = {}
    for k in ("density", "k0"):
        v = params[k]
        if isinstance(v, dict):
            grads[k] = {n: torch.randn(f.shape, generator=g) for n, f in
                        v.items()}
        else:
            params[k] = torch.randn(v.shape, generator=g)
            grads[k] = _grad_like(v, 0.6, seed + 1)
    return params, grads


def _plain_tv(mod, cfg, params, grads, wd, wk, dense, n):
    """The gradients after the TV the way the step added it before the
    in-place entry points: ``grad + common.grid_tv_grad(...)``."""
    out = {}
    for k, w in (("density", wd), ("k0", wk)):
        tv = common.grid_tv_grad(getattr(cfg, f"{k}_type"), params[k],
                                 *mod.tv_weights(cfg, w, n),
                                 None if dense else grads[k])
        out[k] = ({f: grads[k][f] + tv[f] for f in grads[k]}
                  if isinstance(grads[k], dict) else grads[k] + tv)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _clone(tree):
    return ({k: _clone(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.clone())


@pytest.mark.parametrize("family,grid_kw", [
    ("dmpigo", None), ("dvgo", None), ("dmpigo", TENSORF), ("dvgo", TENSORF)])
@pytest.mark.parametrize("dense", [False, True])
def test_train_steps_add_tv_as_before(family, grid_kw, dense):
    """``TrainStep.add_tv`` and ``SRTrainStep.add_tv`` leave the gradients
    the earlier path left, bit for bit: the TV gradient of each grid
    (scaled by the rays of the batch, or the joint step's view count) added
    after it was computed whole."""
    mod = {"dmpigo": dmpigo, "dvgo": dvgo}[family]
    cfg, params = (_dmpigo if family == "dmpigo" else _dvgo)(grid_kw)
    params, grads = _filled(params, 7)
    ct = ConfigDict(dict(weight_tv_density=1e-2, weight_tv_k0=1e-3))
    step = trainer.TrainStep(mod, cfg, ct,
                             render_kwargs={"stepsize": 1.0, "bg": 0.0,
                                            "near": 0.0, "far": 1.0})
    got = _clone(grads)
    step.add_tv(params, got, 96, dense)
    want = _plain_tv(mod, cfg, params, grads, 1e-2, 1e-3, dense, 96)
    sr = types.SimpleNamespace(model_mod=mod, model_cfg=cfg, n_views=3,
                               weight_tv_density=1e-2, weight_tv_k0=1e-3)
    got_sr = _clone(grads)
    sr_trainer.SRTrainStep.add_tv(sr, params, got_sr, dense)
    want_sr = _plain_tv(mod, cfg, params, grads, 1e-2, 1e-3, dense, 3)
    for g, w in ((got, want), (got_sr, want_sr)):
        fg, fw = _flat(g), _flat(w)
        assert fg.keys() == fw.keys()
        for k in fw:
            assert torch.equal(_bits(fg[k]), _bits(fw[k])), k


def test_dvqgo_density_tv_add_():
    """DirectQVGO's TV weights are DirectMPIGO's and DirectContractedVoxGO's
    DirectVoxGO's; ``trainer.add_tv_`` adds DirectQVGO's density TV in place
    and passes over the k0 grid it does not have."""
    assert dcvgo.tv_weights is dvgo.tv_weights
    assert dvqgo.tv_weights is dmpigo.tv_weights
    cfg, params = _dmpigo()
    params, grads = _filled(params, 9)
    got = {"density": grads["density"].clone()}
    trainer.add_tv_(dvqgo, cfg, params, got, {"density": 1e-2, "k0": 1e-3},
                    64, False)
    want = grads["density"] + common.grid_tv_grad(
        cfg.density_type, params["density"],
        *dmpigo.tv_weights(cfg, 1e-2, 64), grads["density"])
    assert list(got) == ["density"]
    assert torch.equal(_bits(got["density"]), _bits(want))


def _adam_case(seed):
    g = torch.Generator().manual_seed(seed)
    p = {"density": torch.randn(3, 4, 5, 1, generator=g),
         "k0": torch.randn(3, 4, 5, 6, generator=g),
         "rgbnet": {"w0": torch.randn(4, 8, generator=g)}}
    grads = {k: (_grad_like(v, 0.7, seed + 1) if k != "rgbnet"
                 else {"w0": torch.randn(4, 8, generator=g)})
             for k, v in p.items()}
    return p, grads


def test_update_counters_only_while_tracing():
    """A masked leaf counts its entries and those with a non-zero gradient
    (the ones the update touches) only while tracing is on; the unmasked
    rgbnet counts nothing. The update itself is the same either way."""
    lrs = {"density": 0.1, "k0": 0.05, "rgbnet": 1e-3}
    skip = frozenset({"density", "k0"})
    out = []
    for on in (False, True):
        p, grads = _adam_case(3)
        st = optim.init_state(p)
        trace.reset()
        if on:
            trace.enable()
        try:
            optim.apply_updates(p, grads, st, lrs, skip_zero_grad=skip)
            s = trace.summary()
        finally:
            trace.disable()
            trace.reset()
        out.append(p)
        if not on:
            assert "update.touched" not in s["counters"]
            assert "update.entries" not in s["counters"]
            continue
        nz = sum(int((grads[k] != 0).sum()) for k in skip)
        assert s["counters"]["update.touched"] == nz
        assert s["counters"]["update.entries"] == 3 * 4 * 5 * 7
        assert 0 < nz < 3 * 4 * 5 * 7
    for a, b in zip(_flat(out[0]).values(), _flat(out[1]).values()):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("masked", [False, True])
def test_update_leaf_plain_unchanged(masked):
    """The CPU leaf update is the plain chunked MaskedAdam: after a first
    step with every gradient non-zero, a second step leaves an entry whose
    gradient is zero alone, moments included, when masked, and moves it by
    its momentum otherwise."""
    p, grads = _adam_case(5)
    p0 = _clone(p)
    st = optim.init_state(p)
    skip = {"k0"} if masked else set()
    full = {"k0": torch.full_like(grads["k0"], 1e-3)}
    optim.apply_updates(p, full, st, {"k0": 0.1}, skip_zero_grad=skip)
    p1, m1 = p["k0"].clone(), st["exp_avg"]["k0"].clone()
    assert bool((p1 != p0["k0"]).all())
    optim.apply_updates(p, {"k0": grads["k0"]}, st, {"k0": 0.1},
                        skip_zero_grad=skip)
    zero = grads["k0"] == 0
    moved = p["k0"] != p1
    assert bool(moved[~zero].all())
    if masked:
        assert not bool(moved[zero].any())
        assert torch.equal(st["exp_avg"]["k0"][zero], m1[zero])
    else:
        assert bool(moved[zero].all())
    assert torch.equal(p["density"], p0["density"])  # no lr: frozen


def test_cuda_grid_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (their callers run the
    plain versions on the CPU) and count nothing when they refuse."""
    grid = torch.zeros(2, 3, 4, 1)
    n_tv, n_adam = cuda_grid.tv_add_grad_.launches, \
        cuda_grid.masked_adam_.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_grid.tv_add_grad_(grid, grid.clone(), 1.0, 1.0, 1.0, False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_grid.masked_adam_(grid, grid.clone(), grid.clone(), grid.clone(),
                               0.1, True)
    assert cuda_grid.tv_add_grad_.launches == n_tv
    assert cuda_grid.masked_adam_.launches == n_adam
