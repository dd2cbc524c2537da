"""The reference against the port's plain paths at toy sizes on the CPU,
in float32: the fields' forwards (outputs and gradients), a whole
training step (loss, gradients, MaskedAdam), the TV gradient and the
SFTNet decode. The reference is a separate, frozen copy; these tests say
that it computes what the program's plain code computes today."""

import numpy as np
import pytest
import torch

from portbench import inputs, program
from portbench.reference import common as C
from portbench.reference import field, sftnet
from portbench.reference import train as ref_train
from portbench.tests.tiny import SEED, tiny  # noqa: F401

CPU = torch.device("cpu")


def _rays(cfg, n=64):
    cam = cfg["camera"]
    K = inputs.intrinsics(cam)
    tr = inputs.traffic("render_4k" if cfg["family"] == "dmpigo"
                        else "flythrough")["path"]
    ro, rd, vd = C.view_rays(cam, K, inputs.path(tr, SEED)[0], CPU)
    idx = torch.randperm(ro.shape[0], generator=torch.Generator()
                         .manual_seed(0))[:n]
    return ro[idx], rd[idx], vd[idx]


@pytest.mark.parametrize("name", ["fern_lg", "chair_syn"])
def test_field_forward_matches_the_port(tiny, name):
    from fourk_nerf_torch.models import dmpigo
    cfg = inputs.config(name)
    params, buffers = inputs.scene(cfg, SEED, CPU)
    ro, rd, vd = _rays(cfg)
    cam, m = cfg["camera"], cfg["model"]
    mod, pc = program.model_module(cfg), program.model_config(cfg)
    kw = dict(stepsize=m["stepsize"], bg=cam["bg"], is_train=True)
    if mod is dmpigo:
        kw["ndc_planes"] = True
    else:
        kw.update(near=cam["near"], far=cam["far"])
    got = mod.forward(pc, params, buffers, ro, rd, vd, **kw)
    ref = field.forward(cfg["family"], m, params, buffers, ro, rd, vd,
                        bg=cam["bg"], near=cam.get("near", 0.0))
    for k in ("rgb_marched", "rgb_feature", "alphainv_last", "weights"):
        torch.testing.assert_close(ref[k], got[k], rtol=1e-5, atol=1e-6)
    depth = (got["weights"] * got["s"]).sum(-1)
    torch.testing.assert_close(ref["depth"], depth, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["fern_lg", "chair_syn"])
def test_training_step_matches_the_port(tiny, name):
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.models import dmpigo
    from fourk_nerf_torch.train import optim, trainer
    cfg = inputs.config(name)
    cam, m, t = cfg["camera"], cfg["model"], dict(cfg["train"])
    t.update(weight_tv_density=1e-3, weight_tv_k0=1e-4)  # TV on for both
    params, buffers = inputs.scene(cfg, SEED, CPU)
    p_ref = {k: (dict(v) if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
    p_ref["rgbnet"] = {k: v.clone() for k, v in params["rgbnet"].items()}
    ro, rd, vd = _rays(cfg, 96)
    rgb = torch.rand((96, 3), generator=torch.Generator().manual_seed(1))
    bg = torch.rand((96, 3), generator=torch.Generator().manual_seed(2))
    mod, pc = program.model_module(cfg), program.model_config(cfg)
    rk = {"near": cam.get("near", 0.0), "far": cam.get("far", 1.0),
          "bg": cam["bg"], "rand_bkgd": t["rand_bkgd"],
          "stepsize": m["stepsize"]}
    if mod is dmpigo:
        rk["ndc_planes"] = True
    ct = ConfigDict(t)
    step = trainer.TrainStep(mod, pc, ct, render_kwargs=rk,
                             skip_zero_grad=frozenset(
                                 t["skip_zero_grad_fields"]))
    opt = optim.init_state(params)
    lrs = optim.build_group_lrs(ct, params)
    noise = bg if t["rand_bkgd"] else None
    for i in range(2):
        loss, _ = step(params, buffers, opt, (ro, rd, vd, rgb), lrs, None,
                       noise, apply_tv=True, tv_dense=i == 0)
    ropt = ref_train.adam_init(p_ref)
    for i in range(2):
        rloss, _, _ = ref_train.step(
            cfg["family"], m, t, p_ref, buffers, ropt, (ro, rd, vd, rgb),
            lrs, bg=bg if t["rand_bkgd"] else cam["bg"],
            near=cam.get("near", 0.0), apply_tv=True, tv_dense=i == 0)
    assert rloss == pytest.approx(float(loss), rel=1e-5)
    for (n, a), (_, b) in zip(ref_train.leaves(p_ref),
                              ref_train.leaves(params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)


def test_tv_gradient_matches_the_port():
    from fourk_nerf_torch.ops import render
    g = torch.randn((6, 7, 5, 3), generator=torch.Generator().manual_seed(3))
    sparse = (torch.rand(g.shape) < 0.5).float()
    for sp in (None, sparse):
        torch.testing.assert_close(
            ref_train.tv_grad(g, 0.3, 0.2, 0.1, sp),
            render.total_variation_grad(g.clone(), 0.3, 0.2, 0.1, sp))


@pytest.mark.parametrize("scale", [1, 4])
def test_sftnet_matches_the_port(scale):
    from fourk_nerf_torch.models import sr_esrnet
    dec = {"scale": scale, "num_feat": 64, "num_block": 1, "num_grow_ch": 32,
           "num_cond": 1}
    w = inputs.decoder({"decoder": dec}, SEED, CPU)
    net = sr_esrnet.SFTNet(scale=scale, num_block=1)
    net.load_state_dict(w)
    x = torch.rand((1, 6, 5, 3), generator=torch.Generator().manual_seed(4))
    c = torch.rand((1, 6, 5, 1), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(sftnet.forward(w, dec, x, c), net(x, c),
                                   rtol=1e-5, atol=1e-5)


def test_rounding_controls():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1000.0, -3.3])
    t = C.round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 and t[2] == 1.0 + 2 ** -9
    assert float(C.round_fp8(torch.tensor([1000.0]))) == 448.0
    assert abs(float(C.round_fp8(torch.tensor([1.1]))) - 1.125) < 1e-7
    a = torch.randn(5, 7, requires_grad=True)
    b = torch.randn(7, 3, requires_grad=True)
    C.mm_tf32(a, b).sum().backward()
    np.testing.assert_allclose(a.grad, torch.ones(5, 3) @ b.detach().T,
                               rtol=2e-3, atol=2e-3)
