"""Port parity: the plain version of the whole-RRDB kernel
(fourk_nerf_torch.ops.cuda_sr.rrdb_plain, which rrdb_apply runs for CPU
tensors) and the fuse_rrdb decode vs the JAX package's _rrdb_kernel in
interpret mode and the flax RRDBSFT. Limits as in tests/test_pallas_sr.py:
0.05 max abs against the Pallas kernel, 0.08 against the float32 module
(three chained bf16 blocks plus the SFT on a +-6 output range)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import sr_esrnet as jsr
from fourk_nerf_tpu.ops import pallas_sr
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import sr_esrnet as tsr
from fourk_nerf_torch.ops import cuda_sr
from test_torch_sr import BF16_TOL, load_convs, numpy_params

F32_TOL = 0.08
bf = torch.bfloat16


def _rrdb(seed=0, H=41, W=50):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, H, W, 64)).astype(np.float32)
    c = rng.normal(size=(1, H, W, 32)).astype(np.float32)
    p = numpy_params(jsr.RRDBSFT(64, 32), rng, jnp.asarray(x), jnp.asarray(c))
    return x, c, p, load_convs(tsr.RRDBSFT(64, 32), p)


def test_rrdb_plain_matches_pallas_kernel_and_flax():
    """41x50 at the smallest legal tiling of the fused kernel (th 8, tw 16
    need Hq >= 40, Wq >= 48): a frame that divides neither."""
    H, W, th, tw = 41, 50, 8, 16
    x, c, p, trr = _rrdb()
    ny, nx = -(-H // th), -(-W // tw)
    body = jnp.pad(jnp.concatenate(
        [jnp.asarray(x[0]), jnp.asarray(c[0]), jnp.zeros((H, W, 32))],
        -1).astype(jnp.bfloat16), ((0, ny * th - H), (0, nx * tw - W), (0, 0)))
    ref = jax.jit(functools.partial(
        pallas_sr.rrdb_apply_pallas, H=H, W=W, th=th, tw=tw, interpret=True))(
        body, pallas_sr.pack_rrdb_weights(p))
    # the condition rides through in channels 64:96
    np.testing.assert_array_equal(
        np.asarray(ref[:H, :W, 64:96].astype(jnp.float32)),
        np.asarray(body[:H, :W, 64:96].astype(jnp.float32)))
    ref = np.asarray(ref[:H, :W, :64].astype(jnp.float32))

    w = cuda_sr.pack_rrdb_weights(trr)
    xt, ct = torch.as_tensor(x[0]).to(bf), torch.as_tensor(c[0]).to(bf)
    cuda_sr.rrdb_apply.launches = 0
    got = cuda_sr.rrdb_apply(xt, ct, w)
    assert cuda_sr.rrdb_apply.launches == 0  # the CPU path launches nothing
    assert got.dtype == bf and tuple(got.shape) == (H, W, 64)
    err = np.abs(got.float().numpy() - ref)
    assert float(err.max()) < BF16_TOL
    assert float((err > 0).mean()) < 0.02  # single bf16 rounding flips

    f32 = np.asarray(jax.jit(jsr.RRDBSFT(64, 32).apply)(
        {"params": p}, jnp.asarray(x), jnp.asarray(c)))[0]
    assert float(np.abs(got.float().numpy() - f32).max()) < F32_TOL

    # carrying float32 between the blocks is part of the function: three
    # rdb_plain calls round x twice more and differ
    cur = cuda_sr.rdb_plain(xt, ct, w.block(0))
    cur = cuda_sr.rdb_plain(cur, ct, w.block(1))
    three = cuda_sr.rdb_plain(cur, ct, w.block(2), xin=xt)
    d = (three.float() - got.float()).abs()
    assert 0 < float(d.max()) < BF16_TOL


def test_pack_rrdb_weights_stacks_the_three_blocks():
    _, _, p, trr = _rrdb(H=8, W=8)
    w = cuda_sr.pack_rrdb_weights(trr)
    jk, jb, jm, jsb = pallas_sr.pack_rrdb_weights(p)
    assert tuple(w.bias.shape) == (3, 5, 64) == jb.shape
    assert tuple(w.sftm.shape) == (3, 12, 32, 64) == jm.shape
    np.testing.assert_allclose(w.bias.numpy(), np.asarray(jb))
    np.testing.assert_allclose(w.sftb.numpy(), np.asarray(jsb))
    np.testing.assert_allclose(w.sftm.numpy(),
                               np.asarray(jm.astype(jnp.float32)))
    # only the third block carries the RRDB's trailing SFT
    assert float(w.sftm[:2, 8:].abs().max()) == 0.0
    assert float(w.sftm[2, 8:].abs().max()) > 0.0
    for r, name in enumerate(("rdb1", "rdb2", "rdb3")):
        one = cuda_sr.pack_rdb_weights(getattr(trr, name),
                                       trr.sft0 if r == 2 else None)
        torch.testing.assert_close(w.block(r).conv, one.conv, rtol=0, atol=0)
        assert w.block(r).tail == (r == 2)


def test_rrdb_apply_refuses_mixed_devices_and_shapes():
    _, _, _, trr = _rrdb(H=8, W=8)
    w = cuda_sr.pack_rrdb_weights(trr)
    x = torch.zeros((8, 8, 64), dtype=bf)
    c = torch.zeros((8, 8, 32), dtype=bf)
    with pytest.raises(ValueError):
        cuda_sr.rrdb_apply(x.to("meta"), c, w)
    out = cuda_sr.rrdb_apply(x, c, w)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("num_block,scale", [(1, 2), (2, 1)])
def test_sftnet_fuse_rrdb_decode_matches_pallas(num_block, scale):
    """sftnet_apply_plain(fuse_rrdb=True) vs sftnet_apply_pallas(
    fuse_rrdb=True, upchain="dilated", interpret): with two RRDBs the
    condition must survive the hand-off between them."""
    H, W = 40, 48
    rng = np.random.default_rng(4 + num_block)
    model = jsr.SFTNet(n_in_colors=3, scale=scale, num_feat=64,
                       num_block=num_block, num_grow_ch=32, num_cond=1)
    x = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    c = rng.uniform(size=(1, H, W, 1)).astype(np.float32)
    p = numpy_params(model, rng, jnp.asarray(x), jnp.asarray(c))
    ref = np.asarray(jax.jit(functools.partial(
        pallas_sr.sftnet_apply_pallas, scale=scale, num_block=num_block,
        th=8, tw=16, interpret=True, upchain="dilated", fuse_rrdb=True))(
        p, jnp.asarray(x), jnp.asarray(c)))
    tm = weights.sftnet_from_flax(p, device="cpu")
    got = cuda_sr.sftnet_apply_plain(tm, torch.as_tensor(x),
                                     torch.as_tensor(c), fuse_rrdb=True,
                                     upchain="dilated")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float(np.abs(got.numpy() - ref).max()) < BF16_TOL
    # sftnet_apply_cuda on the CPU takes the same plain RRDBs
    fused = cuda_sr.sftnet_apply_cuda(tm, torch.as_tensor(x),
                                      torch.as_tensor(c), fuse_rrdb=True,
                                      upchain="dilated")
    torch.testing.assert_close(fused, got, rtol=0, atol=0)
    # and fusing changes the rounding, not the function
    unfused = cuda_sr.sftnet_apply_plain(tm, torch.as_tensor(x),
                                         torch.as_tensor(c),
                                         upchain="dilated")
    d = (unfused - got).abs()
    assert 0 < float(d.max()) < BF16_TOL
