"""Port parity of the StyleGAN-heritage ops (``ops/stylegan.py``) against
the JAX package's, float32 on the CPU, inputs drawn with numpy.

Tolerances: ``bias_act`` 1e-6 relative (the same elementwise functions;
torch's ``elu`` / ``selu`` / ``logaddexp`` round as XLA's within an ulp
or two); the FIR ops 1e-5 (a grouped convolution in another summation
order than ``conv_general_dilated``'s); the hash rows exactly, and the
hash encoding 1e-6 (an index off by one would move it by the table's
scale); ``topp_masking`` exactly, ties included.
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.ops import stylegan as js
from fourk_nerf_torch.ops import stylegan as ts


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file's tests run: beside the other
    test workers, each of torch's small parallel ops would otherwise wait
    on threads the host has no cores for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ACTS = ["linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu",
        "softplus", "swish"]


def test_bias_act_matches_jax_for_all_nine_activations():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 4, 3)).astype(np.float32)
    b = rng.normal(0, 1, 5).astype(np.float32)
    cases = [dict(act=a) for a in ACTS] + [
        dict(act="lrelu", alpha=0.1, gain=1.5, clamp=2.0),
        dict(act="relu", clamp=-1.0), dict(act="swish", gain=1.0)]

    @jax.jit
    def ref(x, b):
        return [js.bias_act(x, b, dim=1, **kw) for kw in cases]

    want = ref(jnp.asarray(x), jnp.asarray(b))
    for kw, w in zip(cases, want):
        got = ts.bias_act(torch.as_tensor(x), torch.as_tensor(b), dim=1, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=str(kw))
    # no bias, another axis
    np.testing.assert_allclose(
        ts.bias_act(torch.as_tensor(x), torch.as_tensor(b[:3]), dim=3,
                    act="tanh").numpy(),
        np.asarray(js.bias_act(jnp.asarray(x), jnp.asarray(b[:3]), dim=3,
                               act="tanh")), atol=1e-6)
    assert ts.bias_act(torch.as_tensor(x), act="relu").min() == 0


def test_setup_filter_matches_jax():
    for f, kw in (([1, 3, 3, 1], {}), ([[1, 2], [3, 4]], {}), (2.0, {}),
                  ([1, 2, 1], dict(normalize=False, gain=4.0))):
        np.testing.assert_allclose(
            ts.setup_filter(f, device="cpu", **kw).numpy(),
            np.asarray(js.setup_filter(f, **kw)), rtol=1e-7)


CASES = [  # (up, down, padding, filter)
    (2, 1, (2, 1, 2, 1), [1, 3, 3, 1]),
    (1, 2, (1, 1, 1, 1), [1, 3, 3, 1]),
    (3, 2, (-1, 2, 0, -2), [1, 2, 1]),   # negative pads crop
    (1, 1, (-2, -1, 1, -1), [[1, 2], [3, 4]]),
    (2, 2, 0, [1, 3, 3, 1]),
]


@pytest.mark.parametrize("up,down,padding,f", CASES)
def test_upfirdn2d_matches_jax(up, down, padding, f):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.normal(size=(2, 3, 9, 7)).astype(np.float32)
    filt = np.asarray(js.setup_filter(f))
    want = jax.jit(functools.partial(js.upfirdn2d, up=up, down=down,
                                     padding=padding, gain=1.5))(
        jnp.asarray(x), jnp.asarray(filt))
    got = ts.upfirdn2d(torch.as_tensor(x), torch.as_tensor(filt), up=up,
                       down=down, padding=padding, gain=1.5)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_resampling_and_filtered_lrelu_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 12, 10)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    f = np.asarray(js.setup_filter([1, 3, 3, 1]))
    one = np.asarray(js.setup_filter([1.0]))

    @jax.jit
    def ref(x, f, one, b):
        return (js.upsample2d(x, f), js.downsample2d(x, f),
                js.downsample2d(x, one),  # a 1-tap filter: negative pads
                js.filtered_lrelu(x, f, f, b, padding=3, clamp=1.0),
                js.filtered_lrelu(x, None, None, b, up=1, down=1))

    want = ref(*(jnp.asarray(a) for a in (x, f, one, b)))
    tx, tf, tone, tb = (torch.as_tensor(a) for a in (x, f, one, b))
    got = (ts.upsample2d(tx, tf), ts.downsample2d(tx, tf),
           ts.downsample2d(tx, tone),
           ts.filtered_lrelu(tx, tf, tf, tb, padding=3, clamp=1.0),
           ts.filtered_lrelu(tx, None, None, tb, up=1, down=1))
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=str(i))
    assert tuple(got[0].shape[-2:]) == (24, 20)
    assert tuple(got[2].shape[-2:]) == (6, 5)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(
        js.bias_act(jnp.asarray(x), jnp.asarray(b), act="lrelu")))


def test_hash_rows_are_exact():
    """The uint32 products wrap: corners far past 2^16 make every product
    exceed 32 bits. Rows against numpy's uint32 arithmetic."""
    rng = np.random.default_rng(4)
    corner = rng.integers(0, 2 ** 31 - 1, (1000, 3), dtype=np.int64)
    corner[:4] = [[0, 0, 0], [1, 1, 1], [2 ** 31 - 2, 5, 2 ** 20],
                  [7, 2 ** 30, 3]]
    c = corner.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (c[:, 0] * np.uint32(1)) ^ (c[:, 1] * np.uint32(2654435761)) ^ \
            (c[:, 2] * np.uint32(805459861))
    for T in (2 ** 19, 1000003):
        np.testing.assert_array_equal(
            ts.hash_index(torch.as_tensor(corner), T).numpy(),
            (h % np.uint32(T)).astype(np.int64))


def test_hash_encode_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    xyz[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1.0]]
    table = rng.uniform(-1, 1, (6, 2 ** 10, 2)).astype(np.float32)
    kw = dict(n_levels=6, base_res=16, per_level_scale=1.3819129,
              features_per_level=2)
    want = jax.jit(functools.partial(js.hash_encode, **kw))(
        jnp.asarray(xyz), jnp.asarray(table))
    got = ts.hash_encode(torch.as_tensor(xyz), torch.as_tensor(table), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    t = ts.init_hash_table(4, 8, 2, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert tuple(t.shape) == (4, 256, 2) and float(t.abs().max()) <= 1e-4
    with pytest.raises(ValueError):
        ts.hash_encode(torch.as_tensor(xyz), t, n_levels=16)


def test_topp_masking_matches_jax_with_ties():
    rng = np.random.default_rng(6)
    w = rng.uniform(size=(50, 40)).astype(np.float32) ** 4
    w[0] = 0.25  # all tied: the stable order keeps the first ones
    w[1, :4] = [0.1, 0.4, 0.4, 0.1]
    w[1, 4:] = 0.0
    w[2] = 0.0   # no weight: nothing reaches p of nothing
    for p in (0.5, 0.9, 0.99):
        want = np.asarray(jax.jit(functools.partial(js.topp_masking, p=p))(
            jnp.asarray(w)))
        got = ts.topp_masking(torch.as_tensor(w), p).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(p))
    got = ts.topp_masking(torch.as_tensor(w), 0.5).numpy()
    assert got[0, :20].all() and not got[0, 20:].any()
    np.testing.assert_array_equal(got[1, :4], [False, True, True, False])
    assert not math.isnan(float(got.sum()))
