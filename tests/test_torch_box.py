"""Port parity: the plain version of the box kernel
(fourk_nerf_torch.ops.box_sweep.render_frame_box, which
ops.cuda_box.sweep_box runs for CPU tensors) vs the JAX package's XLA slab
sweep and its Pallas box kernel in interpret mode, on the scenes of
tests/test_box_sweep.py and tests/test_pallas_box.py.

float32: atol 2e-4 on rgb_marched, depth and alphainv_last with under 2% of
the pixels above it (samples whose nearest-mask or in-range decision sits
on a tie and falls the other way), the limits of tests/test_pallas_box.py.
bf16 (use_bf16=True) against the Pallas kernel's bf16 path: the port rounds
where that kernel rounds, so the same limit holds; the measured maximum is
stated in the test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fourk_nerf_tpu.ops import box_sweep as jbs, pallas_box
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dvgo as tdvgo
from fourk_nerf_torch.ops import box_sweep as tbs, cuda_box
from test_box_sweep import _camera, _scene

KEYS = ("rgb_marched", "depth", "alphainv_last")
ATOL, TIE_FRAC = 2e-4, 0.02
HW = (12, 20)  # no multiple of the JAX side's 8x8 tiles


def port_scene(cfg, params, buffers):
    """A JAX (cfg, params, buffers) dvgo scene as the port's, on the CPU."""
    tcfg = tdvgo.Config(**{f: getattr(cfg, f)
                           for f in cfg.__dataclass_fields__})
    tp, tb = weights.dvgo_from_numpy(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, buffers),
        device="cpu")
    return tcfg, tp, tb


def port_render(cfg, params, buffers, H, W, K, c2w, bg, *, use_bf16=False,
                cuda_entry=False, **kw):
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    fn = cuda_box.render_frame_box_cuda if cuda_entry \
        else tbs.render_frame_box
    out = fn(tcfg, tp, tb, H, W, K, c2w, stepsize=0.5, near=0.2, bg=bg,
             use_bf16=use_bf16, device="cpu", **kw)
    return {k: v.numpy() for k, v in out.items()}


def max_err(got, ref):
    """Per-pixel max abs error over rgb_marched, depth, alphainv_last."""
    err = np.zeros(got["depth"].shape, np.float32)
    for k in KEYS:
        d = np.abs(got[k] - np.asarray(ref[k]))
        err = np.maximum(err, d.max(-1) if d.ndim == 3 else d)
    return err


def assert_close(got, ref, what):
    err = max_err(got, ref)
    frac = float((err > ATOL).mean())
    assert frac < TIE_FRAC, (what, frac, float(err.max()))
    return err


def jax_pair(cfg, params, buffers, H, W, K, c2w, bg, *, use_bf16=False,
             early_exit=True, xla=True):
    kw = dict(stepsize=0.5, near=0.2, bg=bg, use_bf16=use_bf16, tile=8)
    ref = jbs.render_frame_box(cfg, params, buffers, H, W, K, c2w, **kw) \
        if xla else None
    pal = pallas_box.render_frame_box_pallas(
        cfg, params, buffers, H, W, K, c2w, early_exit=early_exit,
        interpret=True, **kw)
    return ref, pal


@pytest.mark.parametrize("rgbnet_dim,early_exit", [
    (6, True), (6, False), (0, True)])
def test_plain_box_matches_xla_and_pallas(rgbnet_dim, early_exit):
    rng = np.random.default_rng(3)
    cfg, params, buffers = _scene(rng, rgbnet_dim=rgbnet_dim)
    H, W = HW
    K, c2w = _camera(H, W)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.7,
                      early_exit=early_exit)
    assert float(np.abs(got["rgb_marched"] - 0.7).max()) > 0.05
    ref, pal = jax_pair(cfg, params, buffers, H, W, K, c2w, 0.7,
                        early_exit=early_exit)
    assert_close(got, ref, "xla")
    # the port and the Pallas kernel share the affine-position form: no
    # pixel differs by more than float32 rounding
    assert float(assert_close(got, pal, "pallas").max()) < ATOL


@pytest.mark.parametrize("angle", [
    (0.0, np.pi),          # flipped sweep axis
    (0.0, 0.5 * np.pi),    # x-major
    (-0.5 * np.pi, 0.2),   # y-major, negative sign
])
def test_plain_box_axes(angle):
    rng = np.random.default_rng(13)
    cfg, params, buffers = _scene(rng)
    H, W = 10, 14
    K, c2w = _camera(H, W, dist=2.8, angle=angle)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.3,
                      cuda_entry=True)
    ref, pal = jax_pair(cfg, params, buffers, H, W, K, c2w, 0.3)
    assert_close(got, ref, "xla")
    assert float(assert_close(got, pal, "pallas").max()) < ATOL


@pytest.mark.parametrize("rgbnet_direct", [False, True])
def test_plain_box_bf16_matches_pallas_bf16(rgbnet_direct):
    """The bf16 path against the Pallas kernel's (``use_bf16=True``): the
    grid, the u hat weights and the MLP's inputs, weights and hidden
    activations are rounded in both. Measured max abs 1.0e-5 here; the limit
    is 1e-4 with no pixel allowed above it."""
    rng = np.random.default_rng(3)
    cfg, params, buffers = _scene(rng)
    if rgbnet_direct:
        cfg, params, buffers = direct_scene(cfg, params, buffers, rng)
    H, W = HW
    K, c2w = _camera(H, W)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.7, use_bf16=True)
    _, pal = jax_pair(cfg, params, buffers, H, W, K, c2w, 0.7, use_bf16=True,
                      xla=False)
    err = max_err(got, pal)
    assert float(err.max()) < 1e-4, float(err.max())
    # and the rounding matters: the float32 render differs from it
    got32 = port_render(cfg, params, buffers, H, W, K, c2w, 0.7)
    assert float(max_err(got, got32).max()) > 1e-4


def direct_scene(cfg, params, buffers, rng):
    """The scene with ``rgbnet_direct=True``: the rgbnet sees all of k0, so
    its first layer is ``cfg.dim0`` = k0_dim + viewdir PE wide."""
    import dataclasses
    cfg = dataclasses.replace(cfg, rgbnet_direct=True)
    w0 = rng.normal(0, 0.3, (cfg.dim0, cfg.rgbnet_width)).astype(np.float32)
    params = {**params, "rgbnet": {**params["rgbnet"], "w0": jnp.asarray(w0)}}
    return cfg, params, buffers


def test_plain_box_rgbnet_direct_matches_pallas():
    rng = np.random.default_rng(3)
    cfg, params, buffers = direct_scene(*_scene(rng), rng)
    H, W = HW
    K, c2w = _camera(H, W)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.7)
    _, pal = jax_pair(cfg, params, buffers, H, W, K, c2w, 0.7, xla=False)
    assert float(assert_close(got, pal, "pallas").max()) < ATOL


def test_plain_box_native_mask_matches_xla():
    """A mask at (12,10,8) under a (24,20,16) grid: the plain version looks
    it up at its own resolution, as the XLA slab sweep's native mode; the
    kernel's frame renderer refuses it, as the Pallas one does."""
    rng = np.random.default_rng(3)
    cfg, params, buffers = _scene(rng, mask_res=(12, 10, 8))
    H, W = HW
    K, c2w = _camera(H, W)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.7)
    ref = jbs.render_frame_box(cfg, params, buffers, H, W, K, c2w,
                               stepsize=0.5, near=0.2, bg=0.7,
                               use_bf16=False, tile=8)
    assert_close(got, ref, "xla native mask")
    with pytest.raises(ValueError):
        port_render(cfg, params, buffers, H, W, K, c2w, 0.7,
                    cuda_entry=True)


def test_plain_box_empty_scene():
    rng = np.random.default_rng(5)
    cfg, params, buffers = _scene(rng)
    buffers["mask_cache"] = jnp.zeros_like(buffers["mask_cache"])
    H, W = 16, 16
    K, c2w = _camera(H, W)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.25,
                      cuda_entry=True)
    np.testing.assert_array_equal(got["rgb_marched"], np.float32(0.25))
    np.testing.assert_array_equal(got["alphainv_last"], np.float32(1.0))
    np.testing.assert_array_equal(got["depth"], np.float32(0.0))


def test_box_frame_missing_the_box_is_background():
    """A camera that looks away from the box: no ray hits it, the maps are
    the background and nothing is swept."""
    rng = np.random.default_rng(5)
    cfg, params, buffers = _scene(rng)
    H, W = 8, 8
    K, c2w = _camera(H, W)
    c2w = c2w.copy()
    c2w[:3, :3] = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.4,
                      cuda_entry=True)
    np.testing.assert_array_equal(got["rgb_marched"], np.float32(0.4))
    np.testing.assert_array_equal(got["rgb_feature"], np.float32(0.0))


def test_box_refusals():
    rng = np.random.default_rng(5)
    cfg, params, buffers = _scene(rng)
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    import dataclasses
    K, c2w = _camera(8, 8)
    for bad in (dataclasses.replace(tcfg, rgbnet_full_implicit=True),
                dataclasses.replace(tcfg, k0_type="TensoRFGrid")):
        for fn in (tbs.render_frame_box, cuda_box.render_frame_box_cuda):
            with pytest.raises(ValueError):
                fn(bad, tp, tb, 8, 8, K, c2w, stepsize=0.5, near=0.2, bg=0.0,
                   device="cpu")
    # no wrapper takes the plain version for a tensor that claims the card
    with pytest.raises((RuntimeError, AssertionError)):
        cuda_box.render_frame_box_cuda(tcfg, tp, tb, 8, 8, K, c2w,
                                       stepsize=0.5, near=0.2, bg=0.0)


def test_box_stats_and_launch_counter():
    rng = np.random.default_rng(3)
    cfg, params, buffers = _scene(rng)
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    K, c2w = _camera(12, 12)
    stats = {}
    cuda_box.sweep_box.launches = 0
    tbs.render_frame_box(tcfg, tp, tb, 12, 12, K, c2w, stepsize=0.5, near=0.2,
                         bg=0.0, use_bf16=False, device="cpu", stats=stats)
    cuda_box.render_frame_box_cuda(tcfg, tp, tb, 12, 12, K, c2w, stepsize=0.5,
                                   near=0.2, bg=0.0, device="cpu")
    assert 0 < stats["mlp_samples"] <= stats["samples"]
    assert cuda_box.sweep_box.launches == 0  # the CPU path launches nothing
    dims, strides = tbs.grid_strides((24, 20, 16), 1, True)
    assert dims == (20, 16, 24) and strides == (19 * 16, -16, 1, 320)
