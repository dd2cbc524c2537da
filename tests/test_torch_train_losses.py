"""Port parity of the encoder's training terms: fourk_nerf_torch's losses,
distortion loss, TV gradients and the softplus gradient of raw2alpha vs
the JAX package, on inputs drawn with numpy and handed to both.

Tolerances: float32 values and gradients 1e-6 relative (+1e-7 absolute
for the terms near zero); the TV gradient is summed in another order (one
clamped difference per axis feeds both voxels), so 1e-6 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict as JConfigDict
from fourk_nerf_tpu.models import dmpigo as jd
from fourk_nerf_tpu.ops import render as jr
from fourk_nerf_tpu.train import losses as jl
from fourk_nerf_torch.models import common, dmpigo as td
from fourk_nerf_torch.ops import render as tr
from fourk_nerf_torch.train import losses as tl

RTOL, ATOL = 1e-6, 1e-7


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("shift", [0.0, 1e-30, -1e-30, 3.0, -3.0, 30.0])
def test_raw2alpha_gradient_matches_jax(shift):
    # the softplus at density + shift = 0 differentiates to 0.5 as in JAX;
    # the formula's own autograd gives 1.0 there
    density = np.zeros(4, np.float32)
    interval = 0.75

    def jf(d):
        return jnp.sum(jr.raw2alpha(d, shift, interval))

    want = np.asarray(jax.grad(jf)(jnp.asarray(density)))
    d = _t(density).requires_grad_(True)
    tr.raw2alpha(d, shift, interval).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_softplus_forward_is_the_kernels_formula():
    x = torch.as_tensor(np.random.default_rng(0).normal(0, 10, 1000)
                        .astype(np.float32))
    ref = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    assert torch.equal(tr.softplus(x), ref)


def _render_out(rng, N=24, K=16):
    w = rng.uniform(0, 0.2, (N, K)).astype(np.float32)
    w[rng.uniform(size=(N, K)) < 0.3] = 0.0
    return dict(
        weights=w, s=np.broadcast_to((np.arange(K) + 0.5) / K, (N, K))
        .astype(np.float32),
        rgb_marched=rng.uniform(size=(N, 3)).astype(np.float32),
        alphainv_last=rng.uniform(size=N).astype(np.float32),
        raw_rgb=rng.uniform(size=(N, K, 3)).astype(np.float32),
        n_max=K)


def test_encoder_losses_and_grads_match_jax():
    rng = np.random.default_rng(1)
    out = _render_out(rng)
    target = rng.uniform(size=(24, 3)).astype(np.float32)
    cfg_train = JConfigDict(weight_main=1.0, weight_entropy_last=0.01,
                            weight_nearclip=0, weight_distortion=0.01,
                            weight_rgbper=0.1)
    diff = ("weights", "rgb_marched", "alphainv_last", "raw_rgb")

    def jloss(x):
        res = {**out, **x}
        loss, terms = jl.encoder_losses(res, jnp.asarray(target), cfg_train,
                                        24)
        return loss, terms

    (jv, jterms), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(out[k]) for k in diff})
    tx = {k: _t(out[k]).requires_grad_(True) for k in diff}
    tout = {k: v if k == "n_max" else _t(v) for k, v in out.items()}
    tv, tterms = tl.encoder_losses({**tout, **tx}, _t(target), cfg_train, 24)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    for k in jterms:
        np.testing.assert_allclose(tterms[k].item(), float(jterms[k]),
                                   rtol=RTOL, err_msg=k)
    for k in diff:
        np.testing.assert_allclose(tx[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=ATOL, err_msg=k)


def test_distortion_loss_matches_jax():
    rng = np.random.default_rng(2)
    out = _render_out(rng)
    want = jr.distortion_loss(jnp.asarray(out["weights"]),
                              jnp.asarray(out["s"]), 1.0 / 16, 24)
    got = tr.distortion_loss(_t(out["weights"]), _t(out["s"]), 1.0 / 16, 24)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (7, 1, 5, 1), (2, 3, 9, 2)])
@pytest.mark.parametrize("sparse", [False, True])
def test_total_variation_grad_matches_jax(shape, sparse):
    rng = np.random.default_rng(3)
    # steps of both signs, some past the +-1 clamp
    grid = rng.normal(0, 1.2, shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    g[rng.uniform(size=shape) < 0.4] = 0.0
    w = (0.3, 0.7, 1.9)
    want = np.asarray(jr.total_variation_grad(
        jnp.asarray(grid), *w, jnp.asarray(g) if sparse else None))
    got = tr.total_variation_grad(_t(grid), *w, _t(g) if sparse else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if sparse:
        assert not got.numpy()[g == 0].any()


@pytest.mark.parametrize("dense", [True, False])
def test_dmpigo_tv_grads_match_jax(dense):
    kw = dict(xyz_min=[-1.1, -1.0, -1.0], xyz_max=[1.1, 1.0, 1.0],
              num_voxels=12 * 10 * 6, mpi_depth=6, rgbnet_dim=5)
    jcfg, tcfg = jd.make_config(**kw), td.make_config(**kw)
    rng = np.random.default_rng(4)
    X, Y, Z = jcfg.world_size
    params = {"density": rng.normal(0, 2, (X, Y, Z, 1)).astype(np.float32),
              "k0": rng.normal(0, 1, (X, Y, Z, 5)).astype(np.float32)}
    grads = {k: np.where(rng.uniform(size=v.shape) < 0.5, 0.0,
                         rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    for name, jf, weight in (("density", jd.density_tv_grad, 1e-5),
                             ("k0", jd.k0_tv_grad, 1e-6)):
        want = np.asarray(jf(jcfg, jp, weight, dense, 4096,
                             jnp.asarray(grads[name])))
        got = common.grid_tv_grad(
            getattr(tcfg, f"{name}_type"), tp[name],
            *td.tv_weights(tcfg, weight, 4096),
            None if dense else _t(grads[name])).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14,
                                   err_msg=name)
