"""Port parity: the fused x4 upsample tail (fourk_nerf_torch.ops.cuda_sr.
uptail_plain, which uptail_apply runs for CPU tensors) vs the JAX package's
uptail_apply_pallas in interpret mode (odd 17x35, just over one 16x32 tile
each way) and vs the XLA chain it fuses (the JAX suite's odd 45x70), to
0.03, the JAX suite's limit for its kernel; the
materialized upchain and the trunk + fused tail vs sftnet_apply_pallas to
0.05 (the bf16 decoder's tolerance). The packed layout is the port's own,
so the packer is held by what the plain version computes from it."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import sr_esrnet as jsr
from fourk_nerf_tpu.ops import pallas_sr
from fourk_nerf_torch import weights
from fourk_nerf_torch.ops import cuda_sr, s2d as ts2d
from test_torch_sr import numpy_params

UPTAIL_TOL = 0.03
BF16_TOL = 0.05


@functools.lru_cache(maxsize=None)
def _net(num_block=1, seed=0):
    """A scale-4 SFTNet: the flax tree (numpy-drawn) and the port's module."""
    model = jsr.SFTNet(n_in_colors=3, scale=4, num_feat=64,
                       num_block=num_block, num_grow_ch=32, num_cond=1)
    p = numpy_params(model, np.random.default_rng(seed),
                     jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))
    return p, weights.sftnet_from_flax(p, device="cpu")


def _xla_tail(params, x):
    """conv_up2 on the materialized upsample, conv_hr, float32 conv_last:
    the chain of the JAX suite's uptail test."""
    bf = jnp.bfloat16
    up = jnp.repeat(jnp.repeat(x.astype(bf), 2, axis=1), 2, axis=2)
    b = pallas_sr._lrelu(pallas_sr._conv(params["conv_up2"], up))
    out = pallas_sr._lrelu(pallas_sr._conv(params["conv_hr"], b))
    k = jnp.asarray(params["conv_last"]["kernel"], bf)
    return (jax.lax.conv_general_dilated(
        out, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
        + jnp.asarray(params["conv_last"]["bias"], jnp.float32)
    ).astype(jnp.float32)


@pytest.mark.parametrize("ref_kind", ["pallas_interpret", "xla_chain"])
def test_uptail_plain_matches_jax(ref_kind):
    """Odd frame sizes, clamped edge tiles on the JAX side (the interpreted
    kernel at the smaller one: its time goes with the number of tiles)."""
    H2, W2 = (17, 35) if ref_kind == "pallas_interpret" else (45, 70)
    p, tm = _net()
    x = np.random.default_rng(7).normal(size=(1, H2, W2, 64)) \
        .astype(np.float32)
    if ref_kind == "pallas_interpret":
        ref = jax.jit(lambda pp, a: pallas_sr.uptail_apply_pallas(
            a, pallas_sr.pack_uptail_weights(pp), th=16, tw=32,
            interpret=True))(p, jnp.asarray(x))
    else:
        ref = jax.jit(_xla_tail)(p, jnp.asarray(x))
    n0 = cuda_sr.uptail_apply.launches
    got = cuda_sr.uptail_apply(torch.as_tensor(x),
                               cuda_sr.pack_uptail_weights(tm))
    assert cuda_sr.uptail_apply.launches == n0  # CPU tensors: the plain version
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (1, 2 * H2, 2 * W2, 3)
    err = np.abs(got.numpy() - np.asarray(ref))
    assert float(err.max()) < UPTAIL_TOL
    if ref_kind == "pallas_interpret":
        # the same function with the same rounding points: what differs is
        # the summation order, so only single bf16 flips remain
        assert float((err > 0).mean()) < 0.02
    # the RGB itself is rounded to bf16
    torch.testing.assert_close(got, got.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_pack_uptail_weights_layout():
    p, tm = _net()
    w = cuda_sr.pack_uptail_weights(tm)
    bf = torch.bfloat16
    assert (w.kup.dtype, w.khr.dtype, w.klast.dtype) == (bf, bf, bf)
    assert tuple(w.kup.shape) == (4, 4, 64, 64)
    assert tuple(w.khr.shape) == (9, 64, 64)
    assert tuple(w.klast.shape) == (9, 64, 8) and tuple(w.bias.shape) == (3, 64)
    # phase kernels: taps summed in float32, rounded once, as the JAX packer
    # (whose kup [4, 2, 192, 64] holds tap (dy, dx) of phase (qy, qx) in
    # rows (dx + qx) * 64 ... of its dy slab)
    want = ts2d.up_phase_kernels(torch.tensor(
        np.asarray(p["conv_up2"]["kernel"]))).to(bf)
    torch.testing.assert_close(w.kup.reshape(2, 2, 2, 2, 64, 64), want,
                               rtol=0, atol=0)
    jkup = np.asarray(jax.jit(pallas_sr.pack_uptail_weights)(p)[0]
                      .astype(jnp.float32))
    for ph in range(4):
        for dy in range(2):
            for dx in range(2):
                lo = (dx + ph % 2) * 64
                np.testing.assert_array_equal(
                    w.kup[ph, 2 * dy + dx].float().numpy(),
                    jkup[ph, dy, lo:lo + 64])
    k_hr = torch.tensor(np.asarray(p["conv_hr"]["kernel"])).to(bf)
    torch.testing.assert_close(w.khr.reshape(3, 3, 64, 64), k_hr,
                               rtol=0, atol=0)
    k_last = torch.tensor(np.asarray(p["conv_last"]["kernel"])).to(bf)
    torch.testing.assert_close(w.klast.reshape(3, 3, 64, 8)[..., :3], k_last,
                               rtol=0, atol=0)
    assert float(w.klast[..., 3:].abs().max()) == 0.0
    np.testing.assert_array_equal(w.bias[2, :3].numpy(),
                                  np.asarray(p["conv_last"]["bias"]))
    assert float(w.bias[2, 3:].abs().max()) == 0.0


def _unpack(w):
    """(kup, khr, klast) as the kernel reads them: the fragment-order
    fields unpacked into the HWIO fields' shapes."""
    m = cuda_sr._matrix_from_fragments
    return (m(w.kupf, 4 * 4 * 64, 64).reshape(4, 4, 64, 64),
            m(w.khrf, 9 * 64, 64).reshape(9, 64, 64),
            m(w.klastf, 9 * 64, 8).reshape(9, 64, 8))


def _b_words(flat, n, i, lane, p=0):
    """The bf16 values lane ``lane`` reads for step ``i`` (and, for N a
    multiple of 16, pair ``p``) of a flat fragment-order B operand."""
    if n == 8:
        return flat.reshape(-1, 32, 4)[i, lane]
    return flat.reshape(-1, n // 16, 32, 8)[i, p, lane]


@pytest.mark.parametrize("field", ["kup", "khr", "klast"])
def test_uptail_fragments_roundtrip(field):
    """Each fragment pack unpacks to its HWIO field bit for bit, and lane
    4 g + t of step i holds the mma.sync B registers: rows 16 i + (2t,
    2t+1, 2t+8, 2t+9) of column 16 p + g, then of column 16 p + 8 + g (one
    column g for conv_last's n8 tile)."""
    _, tm = _net()
    w = cuda_sr.pack_uptail_weights(tm)
    hwio = getattr(w, field)
    flat = getattr(w, field + "f")
    assert flat.dtype == torch.bfloat16 and flat.is_contiguous()
    assert flat.numel() == hwio.numel()
    back = dict(zip(("kup", "khr", "klast"), _unpack(w)))[field]
    assert back.shape == hwio.shape
    assert torch.equal(back.view(torch.int16), hwio.view(torch.int16))
    n = hwio.shape[-1]
    mat = hwio.reshape(-1, n)
    rng = np.random.default_rng(11)
    for _ in range(64):
        i = int(rng.integers(mat.shape[0] // 16))
        lane = int(rng.integers(32))
        g, t = lane // 4, lane % 4
        rows = [16 * i + k for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
        if n == 8:
            want = mat[rows, g]
        else:
            pp = int(rng.integers(n // 16))
            want = torch.cat([mat[rows, 16 * pp + g],
                              mat[rows, 16 * pp + 8 + g]])
        got = _b_words(flat, n, i, lane, 0 if n == 8 else pp)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_uptail_plain_on_unpacked_fragments_is_bitwise():
    """What the kernel reads is the plain version's function: the plain
    tail on the weights unpacked from the fragment order equals the plain
    tail on the HWIO fields bit for bit."""
    _, tm = _net()
    w = cuda_sr.pack_uptail_weights(tm)
    kup, khr, klast = _unpack(w)
    wf = dataclasses.replace(w, kup=kup, khr=khr, klast=klast)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(1, 9, 15, 64)).astype(np.float32))
    a, b = cuda_sr.uptail_plain(x, w), cuda_sr.uptail_plain(x, wf)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_pack_uptail_weights_refuses_what_it_cannot_pack():
    _, tm = _net()
    with pytest.raises(ValueError, match="float32"):
        cuda_sr.pack_uptail_weights(cuda_sr.prepare_sftnet(tm).m16)
    with pytest.raises(ValueError, match="scale-4"):
        cuda_sr.pack_uptail_weights(
            weights.sftnet_init(num_block=1, scale=2, device="cpu"))


@pytest.mark.parametrize("H2,W2", [(1, 1), (2, 3), (16, 32), (17, 33)])
def test_uptail_plain_is_the_library_tail(H2, W2):
    """Sizes below, at and just over the kernel's 16x32 output tile: the
    plain fused tail vs the decode's own three convs (materialized
    upchain), which round conv outputs once more before their bias."""
    _, tm = _net()
    x = torch.as_tensor(np.random.default_rng(H2).normal(
        size=(1, H2, W2, 64)).astype(np.float32))
    got = cuda_sr.uptail_plain(x, cuda_sr.pack_uptail_weights(tm))
    ref = cuda_sr.sftnet_tail(tm, x.to(torch.bfloat16))
    assert got.shape == ref.shape == (1, 2 * H2, 2 * W2, 3)
    assert float((got - ref).abs().max()) < UPTAIL_TOL


def _jax_decode(upchain, num_block):
    return jax.jit(functools.partial(
        pallas_sr.sftnet_apply_pallas, scale=4, num_block=num_block, th=8,
        tw=16, interpret=True, upchain=upchain))


def _frame(seed, H=24, W=32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(1, H, W, 3)).astype(np.float32),
            rng.uniform(size=(1, H, W, 1)).astype(np.float32))


def test_materialized_upchain_matches_pallas():
    p, tm = _net(num_block=2, seed=1)
    x, c = _frame(3)
    ref = np.asarray(_jax_decode("materialized", 2)(p, jnp.asarray(x),
                                                    jnp.asarray(c)))
    got = cuda_sr.sftnet_apply_cuda(tm, torch.as_tensor(x), torch.as_tensor(c),
                                    upchain="materialized")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float(np.abs(got.numpy() - ref).max()) < BF16_TOL
    # it is the default, as in the JAX function, and the plain chain's too
    torch.testing.assert_close(
        cuda_sr.sftnet_apply_cuda(tm, torch.as_tensor(x), torch.as_tensor(c)),
        got, rtol=0, atol=0)
    torch.testing.assert_close(
        cuda_sr.sftnet_apply_plain(tm, torch.as_tensor(x), torch.as_tensor(c)),
        got, rtol=0, atol=0)
    # the dilated form is another rounding of the same function
    dil = cuda_sr.sftnet_apply_cuda(tm, torch.as_tensor(x), torch.as_tensor(c),
                                    upchain="dilated")
    assert 0 < float((dil - got).abs().max()) < BF16_TOL


def test_trunk_and_fused_tail_match_the_dilated_decode():
    """The slice as a whole on the CPU: trunk (dilated conv_up1) then the
    fused tail, vs the JAX dilated decode (1 block: the interpret-mode
    compile is what this test costs)."""
    p, tm = _net(num_block=1, seed=2)
    x, c = _frame(4)
    tx, tc = torch.as_tensor(x), torch.as_tensor(c)
    ref = np.asarray(_jax_decode("dilated", 1)(p, jnp.asarray(x),
                                               jnp.asarray(c)))
    up1 = cuda_sr.sftnet_trunk_cuda(tm, tx, tc, upchain="dilated")
    assert up1.dtype == torch.bfloat16 and tuple(up1.shape) == (1, 48, 64, 64)
    got = cuda_sr.uptail_apply(up1, cuda_sr.pack_uptail_weights(tm))
    assert got.shape == ref.shape
    assert float(np.abs(got.numpy() - ref).max()) < BF16_TOL
    # trunk + library tail is the decode itself
    torch.testing.assert_close(
        cuda_sr.sftnet_tail(tm, up1, upchain="dilated"),
        cuda_sr.sftnet_apply_cuda(tm, tx, tc, upchain="dilated"),
        rtol=0, atol=0)


@pytest.mark.parametrize("fn", [cuda_sr.sftnet_apply_cuda,
                                cuda_sr.sftnet_apply_plain,
                                cuda_sr.sftnet_trunk_cuda])
def test_unknown_upchain_raises(fn):
    _, tm = _net()
    x, c = _frame(5, 8, 8)
    with pytest.raises(ValueError, match="upchain"):
        fn(tm, torch.as_tensor(x), torch.as_tensor(c), upchain="fused")


def test_uptail_apply_refuses_mixed_devices():
    _, tm = _net()
    w = cuda_sr.pack_uptail_weights(tm)
    meta = torch.zeros((1, 4, 4, 64), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_sr.uptail_apply(meta, w)
