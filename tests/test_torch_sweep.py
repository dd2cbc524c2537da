"""Port parity: the plain version of the sweep kernel
(fourk_nerf_torch.ops.plane_sweep.sweep_plain, which ops.cuda_sweep.sweep
runs for CPU tensors) vs the JAX package's XLA plane sweep and its Pallas
sweep kernel in interpret mode, on the scenes of tests/test_plane_sweep.py
and tests/test_pallas_sweep.py. float32 grids, and bf16 (use_bf16=True)
against the Pallas kernel's bf16 path; tolerance 2e-4 as the JAX suite,
with nearest-mask tie flips counted as there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.ops import pallas_sweep, plane_sweep as jps
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import common as tcommon, dmpigo as td
from fourk_nerf_torch.ops import cuda_sweep, plane_sweep as tps
from test_pallas_sweep import _pe_scene
from test_plane_sweep import _cam, _scene

KEYS = ("rgb_marched", "depth", "alphainv_last")


def port_scene(cfg, params, buffers):
    """A JAX (cfg, params, buffers) scene as the port's, on the CPU."""
    tcfg = td.Config(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tp, tb = weights.dmpigo_from_numpy(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, buffers),
        device="cpu")
    return tcfg, tp, tb


def port_render(cfg, params, buffers, H, W, K, c2w, bg, use_bf16=False):
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    out = cuda_sweep.render_frame_cuda(tcfg, tp, tb, H, W, K, c2w,
                                       stepsize=1.0, bg=bg, use_bf16=use_bf16,
                                       device="cpu")
    return {k: v.numpy() for k, v in out.items()}


def max_err(got, ref):
    """Per-pixel max abs error over rgb_marched, depth, alphainv_last."""
    err = np.zeros(got["depth"].shape, np.float32)
    for k in KEYS:
        d = np.abs(got[k] - np.asarray(ref[k]))
        err = np.maximum(err, d.max(-1) if d.ndim == 3 else d)
    return err


@pytest.mark.parametrize("early_exit", [False, True])
def test_plain_sweep_matches_xla_and_pallas(early_exit):
    cfg, params, buffers = _scene()
    H, W = 24, 32
    K, c2w = _cam(H, W)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.5)
    ref = jps.render_frame(cfg, params, buffers, H, W, K, c2w, stepsize=1.0,
                           bg=0.5, tile=8, patch=24, use_bf16=False)
    pal = pallas_sweep.render_frame_pallas(
        cfg, params, buffers, H, W, K, c2w, stepsize=1.0, bg=0.5, tile=8,
        patch=24, use_bf16=False, early_exit=early_exit, interpret=True)
    assert float(max_err(got, ref).max()) < 2e-4
    assert float(max_err(got, pal).max()) < 2e-4
    np.testing.assert_allclose(got["rgb_feature"],
                               np.asarray(pal["rgb_feature"]), atol=2e-4)


def test_plain_sweep_pe_scene_matching_mask():
    """viewdir/spatial PE and a mask at the grid's resolution."""
    cfg, params, buffers = _pe_scene("match")
    H, W = 16, 16
    K, c2w = _cam(H, W, f=40.0)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.25)
    for ref in (jps.render_frame(cfg, params, buffers, H, W, K, c2w,
                                 stepsize=1.0, bg=0.25, tile=4, patch=24,
                                 use_bf16=False),
                pallas_sweep.render_frame_pallas(
                    cfg, params, buffers, H, W, K, c2w, stepsize=1.0, bg=0.25,
                    tile=4, patch=24, use_bf16=False, early_exit=True,
                    interpret=True)):
        err = max_err(got, ref)
        assert float((err > 2e-4).mean()) < 0.02  # nearest-mask tie flips
        assert float(err.max()) < 0.05


def test_plain_sweep_mismatched_mask():
    """A mask at another resolution is nearest-resampled onto the grid, as
    the Pallas kernel does: equal to the Pallas path, and within the JAX
    suite's quantified half-voxel deviation of the XLA sweep's native
    lookup."""
    cfg, params, buffers = _pe_scene("half")
    H, W = 16, 16
    K, c2w = _cam(H, W, f=40.0)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.25)
    pal = pallas_sweep.render_frame_pallas(
        cfg, params, buffers, H, W, K, c2w, stepsize=1.0, bg=0.25, tile=4,
        patch=24, use_bf16=False, early_exit=True, interpret=True)
    assert float(max_err(got, pal).max()) < 2e-4
    ref = jps.render_frame(cfg, params, buffers, H, W, K, c2w, stepsize=1.0,
                           bg=0.25, tile=4, patch=24, use_bf16=False)
    mse = float(np.mean((got["rgb_marched"] - np.asarray(ref["rgb_marched"]))
                        ** 2))
    assert -10 * np.log10(mse + 1e-12) > 20.0


@pytest.mark.parametrize("scene", ["plain", "pe"])
def test_plain_sweep_bf16_matches_pallas_bf16(scene):
    """The main path's precision, use_bf16=True: bf16 grid, bf16 x weights
    and bf16 MLP in both. Held to the float32 limits (2e-4, nearest-mask
    tie flips counted); and much nearer the Pallas bf16 render than the
    port's float32 render is, so the rounding is the reference's."""
    if scene == "plain":
        (cfg, params, buffers), H, W, f, tile = _scene(), 24, 32, 30.0, 8
    else:
        (cfg, params, buffers), H, W, f, tile = _pe_scene("match"), 16, 16, 40.0, 4
    K, c2w = _cam(H, W, f=f)
    pal = pallas_sweep.render_frame_pallas(
        cfg, params, buffers, H, W, K, c2w, stepsize=1.0, bg=0.25, tile=tile,
        patch=24, use_bf16=True, early_exit=True, interpret=True)
    got = port_render(cfg, params, buffers, H, W, K, c2w, 0.25, use_bf16=True)
    err = max_err(got, pal)
    assert float((err > 2e-4).mean()) < 0.02
    assert float(err.max()) < 0.05
    f32 = port_render(cfg, params, buffers, H, W, K, c2w, 0.25)
    assert float(err.mean()) < 0.1 * float(max_err(f32, pal).mean())


def test_pack_mlp_rounds_weights_for_bf16():
    rng = np.random.default_rng(8)
    mlp = [(torch.as_tensor(rng.normal(size=(12, 16)), dtype=torch.float32),
            torch.as_tensor(rng.normal(size=16), dtype=torch.float32)),
           (torch.as_tensor(rng.normal(size=(16, 3)), dtype=torch.float32),
            torch.as_tensor(rng.normal(size=3), dtype=torch.float32))]
    f32, wp, _ = cuda_sweep.pack_mlp(mlp, 12)
    b16, _, _ = cuda_sweep.pack_mlp(mlp, 12, bf16=True)
    w0 = slice(0, 12 * wp)
    b0 = slice(12 * wp, 13 * wp)
    torch.testing.assert_close(b16[w0], tps.round_bf16(f32[w0]), rtol=0, atol=0)
    assert not torch.equal(b16[w0], f32[w0])
    torch.testing.assert_close(b16[b0], f32[b0], rtol=0, atol=0)


def test_nearest_resample_mask_matches_pallas():
    mask = np.random.default_rng(0).uniform(size=(9, 7, 5)) < 0.5
    shape = (17, 12, 9)
    j = np.asarray(pallas_sweep._nearest_resample_mask(jnp.asarray(mask), shape))
    t = tps.nearest_resample_mask(torch.as_tensor(mask), shape).numpy()
    np.testing.assert_array_equal(t, j)


def test_bf16_grid_plain_sweep_close_to_f32():
    """The bf16 grid the kernel reads on the main path: the plain sweep on
    it stays within 1e-2 of the float32 grid (bf16 keeps 8 bits)."""
    cfg, params, buffers = _pe_scene("match")
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    H, W = 16, 16
    K, c2w = _cam(H, W, f=40.0)
    kw = dict(stepsize=1.0, bg=0.25, device="cpu")
    f32 = tps.render_frame(tcfg, tp, tb, H, W, K, c2w, use_bf16=False, **kw)
    b16 = tps.render_frame(tcfg, tp, tb, H, W, K, c2w, use_bf16=True, **kw)
    assert float((f32["rgb_marched"] - b16["rgb_marched"]).abs().max()) < 1e-2


def test_sweep_stats_count_live_and_mlp_samples():
    cfg, params, buffers = _scene()
    tcfg, tp, tb = port_scene(cfg, params, buffers)
    K, c2w = _cam(24, 32)
    packed = tps.pack_grids(tp, tb)
    a, b, vde = tps.prepare_frame(tcfg, 24, 32, K, c2w, device="cpu")
    stats = {}
    X, Y, Z = tcfg.world_size
    tps.sweep_plain(packed.packed, packed.act_shift, a, b, vde,
                    tps.mlp_layers(tp["rgbnet"]), Xl=X, Yl=Y,
                    mask_ch=packed.mask_ch, k0_dim=tcfg.k0_dim, interval=1.0,
                    fast_thres=tcfg.fast_color_thres, spatial_pe=0,
                    act_type="relu", stats=stats)
    assert 0 < stats["mlp_samples"] <= stats["samples"] <= 24 * 32 * Z


@pytest.mark.parametrize("act,spe,vpe,width,depth", [
    ("relu", 0, 0, 64, 3), ("gauss", 2, 4, 16, 4), ("lkrelu", 1, 0, 100, 2)])
def test_pack_mlp_layout_evaluates_like_the_mlp(act, spe, vpe, width, depth):
    """Evaluate the MLP from the flat buffer the way the kernel reads its
    shared memory (W0 [cin0][WP], b0, hidden [WP][WP] + b, output [WP][4]
    + b) and compare with mlp_apply: the layout the kernel sees on the card
    is checked here."""
    rng = np.random.default_rng(7)
    cin0 = 9 + 3 * (1 + 2 * spe) + 3 * (1 + 2 * vpe)
    dims = [cin0] + [width] * (depth - 1) + [3]
    mlp = [(torch.as_tensor(rng.normal(size=(dims[i], dims[i + 1])) * 0.3,
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=dims[i + 1]) * 0.1,
                            dtype=torch.float32)) for i in range(depth)]
    flat, wp, n = cuda_sweep.pack_mlp(mlp, cin0)
    assert wp in (64, 128) and wp >= width and n == depth
    act_fn = tcommon.activation(act)
    x = torch.as_tensor(rng.normal(size=(5, cin0)), dtype=torch.float32)
    o = 0
    W0 = flat[o:o + cin0 * wp].reshape(cin0, wp)
    o += cin0 * wp
    h = x @ W0 + flat[o:o + wp]
    o += wp
    for _ in range(n - 2):
        Wl = flat[o:o + wp * wp].reshape(wp, wp)
        o += wp * wp
        h = act_fn(h) @ Wl + flat[o:o + wp]
        o += wp
    out = act_fn(h) @ flat[o:o + wp * 4].reshape(wp, 4) + flat[o + wp * 4:o + wp * 4 + 4]
    assert o + wp * 4 + 4 == flat.numel()
    ref = tcommon.mlp_apply({**{f"w{i}": w for i, (w, _) in enumerate(mlp)},
                             **{f"b{i}": b for i, (_, b) in enumerate(mlp)}},
                            x, act_fn)
    np.testing.assert_allclose(out[:, :3].numpy(), ref.numpy(), atol=1e-5)
    assert float(out[:, 3].abs().max()) == 0.0


def test_sweep_wrapper_refuses_mixed_devices():
    t = torch.zeros
    mlp = [(t(10, 64), t(64)), (t(64, 3), t(3))]
    meta = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError):
        cuda_sweep.sweep(t(2, 3, 3, 8), t(2), meta, t(4, 2), t(4, 3), mlp,
                         Xl=3, Yl=3, mask_ch=7, k0_dim=4, interval=1.0,
                         fast_thres=0.0, spatial_pe=0, act_type="relu")
