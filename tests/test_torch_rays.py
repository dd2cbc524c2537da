"""Port parity: fourk_nerf_torch.ops.rays / ops.render vs the JAX package.

Inputs are made with numpy and handed to both; float32 paths agree to
1e-5 (different summation/ordering of the same float32 arithmetic)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.ops import rays as jrays, render as jrender
from fourk_nerf_torch.ops import rays as trays, render as trender

TOL = 1e-5


def _cam(H, W, f, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[f, 0, W / 2.0], [0, f * 1.1, H / 2.0], [0, 0, 1]],
                 dtype=np.float32)
    # a random rotation (QR of a gaussian) and translation
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)
    return K, c2w


@pytest.mark.parametrize("inverse_y", [False, True])
@pytest.mark.parametrize("flip_x,flip_y", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("mode", ["center", "lefttop"])
def test_get_rays_matches_jax(inverse_y, flip_x, flip_y, mode):
    H, W = 5, 7
    K, c2w = _cam(H, W, 9.0)
    jo, jd = jrays.get_rays(H, W, K, c2w, inverse_y, flip_x, flip_y, mode)
    to, td = trays.get_rays(H, W, K, c2w, inverse_y, flip_x, flip_y, mode,
                           device="cpu")
    assert to.shape == (H, W, 3) and td.shape == (H, W, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)


@pytest.mark.parametrize("ndc", [False, True])
def test_get_rays_of_a_view_matches_jax(ndc):
    H, W = 6, 8
    K = np.array([[7.0, 0, 4.0], [0, 7.0, 3.0], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    jout = jrays.get_rays_of_a_view(H, W, K, c2w, ndc, False, False, False)
    tout = trays.get_rays_of_a_view(H, W, K, c2w, ndc, False, False, False,
                                   device="cpu")
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)


def test_ndc_rays_matches_jax():
    rng = np.random.default_rng(1)
    ro = rng.normal(size=(32, 3)).astype(np.float32)
    ro[:, 2] = -rng.uniform(2, 4, 32)
    rd = rng.normal(size=(32, 3)).astype(np.float32)
    rd[:, 2] = -rng.uniform(0.5, 1.5, 32)
    jo, jd = jrays.ndc_rays(40, 50, 30.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    to, td = trays.ndc_rays(40, 50, 30.0, 1.0, torch.as_tensor(ro),
                            torch.as_tensor(rd))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=TOL)


@pytest.mark.parametrize("n_freqs", [0, 2, 4])
def test_positional_encoding_matches_jax(n_freqs):
    x = np.random.default_rng(2).uniform(-1, 1, (4, 5, 3)).astype(np.float32)
    j = np.asarray(jrays.positional_encoding(jnp.asarray(x), n_freqs))
    t = trays.positional_encoding(torch.as_tensor(x), n_freqs).numpy()
    assert t.shape == j.shape == (4, 5, 3 * (1 + 2 * n_freqs))
    np.testing.assert_allclose(t, j, atol=TOL)


def test_positional_encoding_of_no_rows():
    x = torch.zeros((0, 3))
    assert trays.positional_encoding(x, 2).shape == (0, 15)


def test_render_math_matches_jax():
    rng = np.random.default_rng(3)
    dens = rng.normal(-1, 3, (16, 24)).astype(np.float32)
    valid = rng.uniform(size=(16, 24)) < 0.8
    ja = jrender.raw2alpha(jnp.asarray(dens), -2.0, 0.7)
    ta = trender.raw2alpha(torch.as_tensor(dens), -2.0, 0.7)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL)
    jw, jl, jT = jrender.alpha2weight(ja, jnp.asarray(valid))
    tw, tl, tT = trender.alpha2weight(ta, torch.as_tensor(valid))
    for t, j in ((tw, jw), (tl, jl), (tT, jT)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)
    vals = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trender.composite(tw, torch.as_tensor(vals)).numpy(),
        np.asarray(jrender.composite(jw, jnp.asarray(vals))), atol=TOL)
