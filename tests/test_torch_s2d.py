"""Port parity: fourk_nerf_torch.ops.s2d vs the JAX package's ops/s2d.py.
The weight-space transforms (s2d, d2s, s2d_kernel, up_phase_kernels,
conv_up_phase, block_diag_1x1) are exact rewrites and agree to 1e-5 in
float32; the whole space-to-depth decode sftnet_apply_s2d (bf16 activations)
agrees with the JAX function to 0.06, the JAX suite's tolerance for it,
at an even and an odd frame size and with both wide dtypes."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import sr_esrnet as jsr
from fourk_nerf_tpu.ops import s2d as js2d
from fourk_nerf_torch import weights
from fourk_nerf_torch.ops import s2d as ts2d
from test_torch_sr import numpy_params

F32_TOL = 1e-5
S2D_TOL = 0.06


def _pair(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def test_s2d_and_d2s_match_jax():
    jx, tx = _pair(np.random.default_rng(0), 2, 6, 8, 5)
    got = ts2d.s2d(tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js2d.s2d(jx)))
    np.testing.assert_array_equal(ts2d.d2s(got).numpy(), tx.numpy())
    np.testing.assert_array_equal(ts2d.d2s(tx[..., :4]).numpy(),
                                  np.asarray(js2d.d2s(jx[..., :4])))


@pytest.mark.parametrize("fn", ["s2d_kernel", "up_phase_kernels",
                                "up_dilated_kernel"])
def test_kernel_transforms_match_jax(fn):
    jk, tk = _pair(np.random.default_rng(1), 3, 3, 4, 6)
    ref = np.asarray(getattr(js2d, fn)(jk))
    got = getattr(ts2d, fn)(tk)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL)


def test_s2d_kernel_is_the_same_conv():
    rng = np.random.default_rng(2)
    _, x = _pair(rng, 1, 12, 16, 3)
    _, K = _pair(rng, 3, 3, 3, 5)
    same = (1, 1, 1, 1)
    ref = ts2d._conv_f32(x, K, same)
    got = ts2d.d2s(ts2d._conv_f32(ts2d.s2d(x), ts2d.s2d_kernel(K), same))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_up_phase_matches_jax(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, 1, 11, 9, 4)
    jk, tk = _pair(rng, 3, 3, 4, 6)
    jb, tb = _pair(rng, 6)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(js2d.conv_up_phase(
        jx.astype(jdt), jk.astype(jdt), jb.astype(jdt)).astype(jnp.float32))
    got = ts2d.conv_up_phase(tx.to(tdt), tk.to(tdt), tb.to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (1, 22, 18, 6)
    # bf16: one rounding of a value of magnitude <~ 8 on either side
    tol = F32_TOL if dtype == "float32" else 2.0 ** -4
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)
    if dtype == "float32":  # and it is the dilated form's function
        np.testing.assert_allclose(
            got.numpy(), ts2d.conv_up_dilated(tx, tk, tb).numpy(), atol=F32_TOL)


def test_block_diag_1x1_matches_jax():
    jk, tk = _pair(np.random.default_rng(4), 5, 7)
    np.testing.assert_array_equal(ts2d.block_diag_1x1(tk).numpy(),
                                  np.asarray(js2d.block_diag_1x1(jk)))


def test_apply_mask_repeats_to_the_activation_width():
    rng = np.random.default_rng(5)
    jy, ty = _pair(rng, 1, 3, 4, 8)
    m = (rng.uniform(size=(1, 3, 4, 4)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        ts2d._apply_mask(ty, torch.as_tensor(m)).numpy(),
        np.asarray(js2d._apply_mask(jy, jnp.asarray(m))))


@functools.lru_cache(maxsize=None)
def _jax_s2d(wide):
    return jax.jit(functools.partial(
        js2d.sftnet_apply_s2d, scale=4, num_block=1,
        wide_dtype=getattr(jnp, wide)))


@pytest.mark.parametrize("wide", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", [(32, 48), (29, 41)])
def test_sftnet_apply_s2d_matches_jax(H, W, wide):
    """Even and odd frame sizes (odd exercises the padding and the 4-channel
    phase mask), 1 block."""
    rng = np.random.default_rng(2)
    model = jsr.SFTNet(n_in_colors=3, scale=4, num_feat=64, num_block=1,
                       num_grow_ch=32, num_cond=1)
    x = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    c = rng.normal(size=(1, H, W, 1)).astype(np.float32)
    p = numpy_params(model, rng, jnp.asarray(x), jnp.asarray(c))
    ref = np.asarray(_jax_s2d(wide)(p, jnp.asarray(x), jnp.asarray(c)))
    tm = weights.sftnet_from_flax(p, device="cpu")
    got = ts2d.sftnet_apply_s2d(tm, torch.as_tensor(x), torch.as_tensor(c),
                                wide_dtype=getattr(torch, wide))
    assert got.dtype == torch.float32 and got.shape == ref.shape \
        == (1, 4 * H, 4 * W, 3)
    assert float(np.abs(got.numpy() - ref).max()) < S2D_TOL
    # and both stay near the float32 module
    with torch.no_grad():
        full = tm(torch.as_tensor(x), torch.as_tensor(c))
    assert float((got - full).abs().max()) < S2D_TOL
