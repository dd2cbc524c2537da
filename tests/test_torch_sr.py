"""Port parity: the SFTNet decoder (fourk_nerf_torch.models.sr_esrnet), the
plain version of the dense-block kernel (ops.cuda_sr.rdb_plain, which
rdb_apply runs for CPU tensors) and conv_up_dilated vs the JAX package.
float32 paths agree to 1e-4 (relative to the output scale); bf16 paths to
0.05, the JAX suite's dense-block tolerance."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import sr_esrnet as jsr
from fourk_nerf_tpu.ops import pallas_sr, s2d as js2d
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import sr_esrnet as tsr
from fourk_nerf_torch.ops import cuda_sr, s2d as ts2d

BF16_TOL = 0.05


def numpy_params(module, rng, *args):
    """A flax parameter tree for ``module`` with values drawn by numpy.
    Shapes come from ``jax.eval_shape`` (tracing only, no compiling).
    Conv kernels follow the flax inits' scales: dense-block convs at 0.1x
    kaiming normal, the rest lecun normal. Biases, zero at flax init, are
    uniform in +-0.1 so the checks see them."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        names = [k.key for k in path]
        if names[-1] == "bias":
            v = rng.uniform(-0.1, 0.1, leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[:-1]))
            dense = (any(n.startswith("rdb") for n in names)
                     and names[-2].startswith("conv"))
            std = 0.1 * np.sqrt(2.0 / fan_in) if dense else np.sqrt(1.0 / fan_in)
            v = rng.normal(0.0, std, leaf.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def load_convs(module, tree):
    """Copy a flax subtree into a port module by name (HWIO -> OIHW)."""
    with torch.no_grad():
        for path, mod in module.named_modules():
            if isinstance(mod, tsr.Conv):
                node = tree
                for part in path.split("."):
                    node = node[part]
                mod.weight.copy_(torch.tensor(
                    np.asarray(node["kernel"])).permute(3, 2, 0, 1))
                mod.bias.copy_(torch.tensor(np.asarray(node["bias"])))
    return module


def _rrdb(seed=0, H=37, W=55):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, H, W, 64)).astype(np.float32)
    c = rng.normal(size=(1, H, W, 32)).astype(np.float32)
    p = numpy_params(jsr.RRDBSFT(64, 32), rng, jnp.asarray(x), jnp.asarray(c))
    return x, c, p, load_convs(tsr.RRDBSFT(64, 32), p), rng


# the JAX references run jitted: one compile of the whole graph costs far
# less on the CPU than compiling each op eagerly
sftnet_pallas = jax.jit(functools.partial(
    pallas_sr.sftnet_apply_pallas, scale=4, num_block=1, th=8, tw=16,
    interpret=True, upchain="dilated"))


def nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2)


def test_dense_block_f32_matches_flax():
    x, c, p, trr, _ = _rrdb()
    ref = np.asarray(jax.jit(jsr.ResidualDenseBlockSFT(64, 32).apply)(
        {"params": p["rdb1"]}, jnp.asarray(x), jnp.asarray(c)))
    with torch.no_grad():
        got = trr.rdb1(nchw(x), nchw(c)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_rrdb_f32_matches_flax():
    x, c, p, trr, _ = _rrdb(seed=1, H=12, W=20)
    ref = np.asarray(jax.jit(jsr.RRDBSFT(64, 32).apply)(
        {"params": p}, jnp.asarray(x), jnp.asarray(c)))
    with torch.no_grad():
        got = trr(nchw(x), nchw(c)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("tail", [False, True])
def test_rdb_plain_matches_pallas_kernel(tail):
    """bf16 dense block vs rdb_apply_pallas (interpret) at 37x55, tile
    16x32: a frame that does not divide the tile grid."""
    H, W, th, tw = 37, 55, 16, 32
    x, c, p, trr, rng = _rrdb()
    xin = rng.normal(size=(H, W, 64)).astype(np.float32)
    ny, nx = -(-H // th), -(-W // tw)

    def body(a, b):
        return jnp.pad(jnp.concatenate([jnp.asarray(a), b], -1).astype(
            jnp.bfloat16), ((0, ny * th - H), (0, nx * tw - W), (0, 0)))

    ref = jax.jit(functools.partial(
        pallas_sr.rdb_apply_pallas, H=H, W=W, th=th, tw=tw, interpret=True))(
        body(x[0], jnp.concatenate([jnp.asarray(c[0]),
                                    jnp.zeros((H, W, 32))], -1)),
        pallas_sr.pack_rdb_weights(p["rdb3"], p["sft0"] if tail else None),
        xin=body(xin, jnp.zeros((H, W, 64))) if tail else None)[:H, :W, :64]
    w = cuda_sr.pack_rdb_weights(trr.rdb3, trr.sft0 if tail else None)
    bf = torch.bfloat16
    got = cuda_sr.rdb_apply(torch.as_tensor(x[0]).to(bf),
                            torch.as_tensor(c[0]).to(bf), w,
                            xin=torch.as_tensor(xin).to(bf) if tail else None)
    assert got.dtype == bf and tuple(got.shape) == (H, W, 64)
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert float(err.max()) < BF16_TOL
    assert float((err > 0).mean()) < 0.01  # single bf16 rounding flips


def test_pack_rdb_weights_roundtrip():
    _, _, _, trr, _ = _rrdb(H=8, W=8)
    w = cuda_sr.pack_rdb_weights(trr.rdb2, trr.sft0)
    assert w.tail and w.conv.dtype == torch.bfloat16
    for s in range(5):
        conv = getattr(trr.rdb2, f"conv{s + 1}")
        torch.testing.assert_close(cuda_sr._unpack_conv(w, s),
                                   conv.weight.to(torch.bfloat16).float())
        torch.testing.assert_close(w.bias[s, :conv.bias.numel()], conv.bias)
    k = trr.sft0.shift1.weight[:, :, 0, 0].t()
    torch.testing.assert_close(w.sftm[11, :32, :64],
                               k.to(torch.bfloat16).float())


def test_rdb_apply_refuses_wrong_tail_weights():
    _, _, _, trr, _ = _rrdb(H=8, W=8)
    x = torch.zeros((8, 8, 64), dtype=torch.bfloat16)
    c = torch.zeros((8, 8, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cuda_sr.rdb_apply(x, c, cuda_sr.pack_rdb_weights(trr.rdb1), xin=x)
    with pytest.raises(ValueError):
        cuda_sr.rdb_apply(x, c, cuda_sr.pack_rdb_weights(trr.rdb3, trr.sft0))


def _sftnet(H=16, W=20, seed=0):
    rng = np.random.default_rng(seed)
    model = jsr.SFTNet(n_in_colors=3, scale=4, num_feat=64, num_block=1,
                       num_grow_ch=32, num_cond=1)
    x = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    c = rng.uniform(size=(1, H, W, 1)).astype(np.float32)
    p = numpy_params(model, rng, jnp.asarray(x), jnp.asarray(c))
    return model, p, x, c, weights.sftnet_from_flax(p, device="cpu")


def test_sftnet_f32_matches_flax():
    model, p, x, c, tm = _sftnet()
    ref = np.asarray(jax.jit(model.apply)({"params": p}, jnp.asarray(x),
                                          jnp.asarray(c)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(c)).numpy()
    assert got.shape == ref.shape == (1, 64, 80, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_sftnet_apply_bf16_matches_flax():
    model, p, x, c, tm = _sftnet(seed=1)
    ref = np.asarray(jax.jit(functools.partial(jsr.apply_bf16, model))(
        p, jnp.asarray(x), jnp.asarray(c)))
    got = tsr.apply_bf16(tm, torch.as_tensor(x), torch.as_tensor(c)).numpy()
    assert got.dtype == np.float32
    assert float(np.abs(got - ref).max()) < BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_up_dilated_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(1, 7, 9, 16)) * 0.2).astype(np.float32)
    K = (rng.normal(size=(3, 3, 16, 8)) * 0.2).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(js2d.conv_up_dilated(
        jnp.asarray(x, jdt), jnp.asarray(K, jdt), jnp.asarray(b, jdt)
    ).astype(jnp.float32))
    got = ts2d.conv_up_dilated(torch.as_tensor(x).to(tdt),
                               torch.as_tensor(K).to(tdt),
                               torch.as_tensor(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (1, 14, 18, 8)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)
    # and it is conv3x3(nearest_up2(x))
    up = tsr.nearest_up2(torch.as_tensor(x).permute(0, 3, 1, 2))
    direct = tsr.conv_nchw(up, torch.as_tensor(K).permute(3, 2, 0, 1),
                           torch.as_tensor(b)).permute(0, 2, 3, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


def test_sftnet_fused_decode_matches_pallas():
    """sftnet_apply_cuda on the CPU (plain dense blocks) vs the JAX
    package's sftnet_apply_pallas (interpret, dilated upchain)."""
    model, p, x, c, tm = _sftnet(H=24, W=32, seed=3)
    ref = np.asarray(sftnet_pallas(p, jnp.asarray(x), jnp.asarray(c)))
    got = cuda_sr.sftnet_apply_cuda(tm, torch.as_tensor(x), torch.as_tensor(c))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert float(np.abs(got.numpy() - ref).max()) < BF16_TOL
    plain = cuda_sr.sftnet_apply_plain(cuda_sr.prepare_sftnet(tm),
                                       torch.as_tensor(x), torch.as_tensor(c))
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_sftnet_init_is_seeded_and_shaped():
    a = weights.sftnet_init(num_block=1, seed=4, device="cpu")
    b = weights.sftnet_init(num_block=1, seed=4, device="cpu")
    torch.testing.assert_close(a.body0.rdb1.conv5.weight,
                               b.body0.rdb1.conv5.weight)
    assert tuple(a.body0.rdb1.conv5.weight.shape) == (64, 192, 3, 3)
    assert float(a.conv_first.bias.detach().abs().max()) > 0
