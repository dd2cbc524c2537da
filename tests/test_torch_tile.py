"""Port parity: the rest of the SR decode surface of
fourk_nerf_torch.models.sr_esrnet vs the JAX package: the plain RRDBNetBPS
generator (weights carried over by weights.rrdbnet_bps_from_flax), the tiled
inference tile_process, the standalone enhance, and the tiled decode of
pipeline.render_video(test_tile=...). All float32: 1e-4 (relative to the
output scale where the output exceeds 1)."""

import ast
import functools
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from fourk_nerf_tpu.models import sr_esrnet as jsr
from fourk_nerf_torch import pipeline, weights
from fourk_nerf_torch.models import dvgo as tdv, sr_esrnet as tsr
from fourk_nerf_torch.ops import cuda_sr
from fourk_nerf_torch.train import trainer as ttrainer
from test_box_sweep import _camera, _scene as box_scene
from test_torch_box import port_scene as port_box_scene
from test_torch_sr import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _sftnet(scale=4, seed=0):
    """A narrow SFTNet (16 feat, 2 blocks, grow 8): flax module, numpy-drawn
    tree, the jitted JAX forward and the port's module."""
    model = jsr.SFTNet(n_in_colors=3, scale=scale, num_feat=16, num_block=2,
                       num_grow_ch=8, num_cond=1)
    p = numpy_params(model, np.random.default_rng(seed),
                     jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))
    fwd = jax.jit(lambda pp, x, c: model.apply({"params": pp}, x, c))
    return p, fwd, weights.sftnet_from_flax(p, device="cpu")


def _img(seed, H, W):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(1, H, W, 3)).astype(np.float32),
            rng.uniform(size=(1, H, W, 1)).astype(np.float32))


def _tol(ref):
    return F32_TOL * max(1.0, float(np.abs(ref).max()))


def test_pixel_shuffle2_matches_jax_and_torch():
    """RRDBNetBPS shuffles with F.pixel_shuffle on NCHW: the same map as the
    JAX package's NHWC _pixel_shuffle2."""
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 12)).astype(np.float32)
    got = F.pixel_shuffle(torch.as_tensor(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).numpy(),
        np.asarray(jsr._pixel_shuffle2(jnp.asarray(x))))


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_bps_matches_flax(scale):
    rng = np.random.default_rng(1)
    model = jsr.RRDBNetBPS(n_colors=3, scale=scale, num_feat=16, num_block=2,
                           num_grow_ch=8)
    x = rng.uniform(size=(1, 10, 12, 3)).astype(np.float32)
    p = numpy_params(model, rng, jnp.asarray(x))
    ref = np.asarray(jax.jit(lambda pp, a: model.apply({"params": pp}, a))(
        p, jnp.asarray(x)))
    tm = weights.rrdbnet_bps_from_flax(p, device="cpu")
    assert (tm.scale, tm.num_block) == (scale, 2)
    assert hasattr(tm, "ps_preconv2") == (scale == 4)
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (1, 10 * scale, 12 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=_tol(ref))


def test_plain_dense_block_and_rrdb_match_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 9, 11, 16)).astype(np.float32)
    p = numpy_params(jsr.RRDB(16, 8), rng, jnp.asarray(x))
    ref = np.asarray(jax.jit(jsr.RRDB(16, 8).apply)({"params": p},
                                                    jnp.asarray(x)))
    trr = weights.load_flax_convs(tsr.RRDB(16, 8), p)
    with torch.no_grad():
        got = trr(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref))


def test_rrdbnet_bps_from_flax_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.rrdbnet_bps_from_flax({})


def test_tile_process_matches_jax_and_the_per_tile_oracle():
    """12x10 frame, tiles of 6 with pad 4: the port vs the JAX scan, and vs
    a per-tile loop with the same pad / crop arithmetic written out (the
    oracle of the JAX suite)."""
    p, fwd, tm = _sftnet()
    x, c = _img(0, 12, 10)
    scale, ts, tp = 4, 6, 4
    # jitted as a whole: eager, every pad / slice / scan compiles on its own
    ref = np.asarray(jax.jit(lambda pp, a, b: jsr.tile_process(
        fwd, pp, a, b, tile_size=ts, tile_pad=tp))(
        p, jnp.asarray(x), jnp.asarray(c)))
    with torch.no_grad():
        got = tsr.tile_process(tm, torch.as_tensor(x), torch.as_tensor(c),
                               tile_size=ts, tile_pad=tp)
    assert tuple(got.shape) == ref.shape == (1, 48, 40, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref))

    H, W = 12, 10
    ny, nx = math.ceil(H / ts), math.ceil(W / ts)
    pad = ((0, 0), (tp, ny * ts + tp - H), (tp, nx * ts + tp - W), (0, 0))
    xp, cp = np.pad(x, pad, mode="edge"), np.pad(c, pad, mode="edge")
    out = np.zeros((H * scale, W * scale, 3), np.float32)
    for y in range(ny):
        for xx in range(nx):
            sy, sx = y * ts, xx * ts
            with torch.no_grad():
                sr = tm(torch.as_tensor(xp[:, sy:sy + ts + 2 * tp,
                                           sx:sx + ts + 2 * tp]),
                        torch.as_tensor(cp[:, sy:sy + ts + 2 * tp,
                                           sx:sx + ts + 2 * tp]))[0].numpy()
            core = sr[tp * scale:(tp + ts) * scale, tp * scale:(tp + ts) * scale]
            oy, ox = sy * scale, sx * scale
            h = min(ts * scale, H * scale - oy)
            w = min(ts * scale, W * scale - ox)
            out[oy:oy + h, ox:ox + w] = core[:h, :w]
    np.testing.assert_allclose(got[0].numpy(), out, atol=1e-5)
    # away from exactness, it stays near the seamless full-frame forward
    with torch.no_grad():
        full = tm(torch.as_tensor(x), torch.as_tensor(c))
    assert float((got - full).abs().mean()) < 0.1


@pytest.mark.parametrize("tile_size,with_cond", [(0, True), (8, True),
                                                 (0, False)])
def test_enhance_matches_jax(tile_size, with_cond):
    """13x11 frame: reflect pre-pad 4, modulus pad to 8, whole or tiled."""
    x, c = _img(3, 13, 11)
    if with_cond:
        p, fwd, tm = _sftnet()
        jfn, tfn = fwd, tm
        jc, tc = jnp.asarray(c), torch.as_tensor(c)
    else:
        model = jsr.RRDBNetBPS(n_colors=3, scale=4, num_feat=16, num_block=1,
                               num_grow_ch=8)
        p = numpy_params(model, np.random.default_rng(4), jnp.asarray(x))
        jfn = jax.jit(lambda pp, a: model.apply({"params": pp}, a))
        tfn = weights.rrdbnet_bps_from_flax(p, device="cpu")
        jc = tc = None
    kw = dict(scale=4, pre_pad=4, mod=8, tile_size=tile_size, tile_pad=3)
    ref = np.asarray(jsr.enhance(jfn, p, jnp.asarray(x), jc, **kw))
    with torch.no_grad():
        got = tsr.enhance(tfn, torch.as_tensor(x), tc, **kw)
    assert tuple(got.shape) == ref.shape == (1, 52, 44, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref))


def test_render_video_test_tile_matches_jax_tile_process():
    """The small bounded scene's fly-through decoded in tiles: each frame
    equals the JAX tile_process of the float32 SFTNet on the same encoder
    output, clipped; no kernel wrapper is reached."""
    h, w, tile = 16, 24, 10
    cfg, params, buffers = box_scene(np.random.default_rng(3))
    tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    K, _ = _camera(h, w)
    poses = [_camera(h, w, angle=a)[1] for a in ((0.4, 0.3), (0.0, np.pi))]
    p, fwd, tm = _sftnet(scale=2, seed=5)
    counts = (cuda_sr.rdb_apply, cuda_sr.rrdb_apply, cuda_sr.uptail_apply)
    for fn in counts:
        fn.launches = 0
    out = pipeline.render_video(
        tdv, tcfg, tp, tb, tm, poses, (h, w), K, data=ttrainer.DataFlags(),
        render_kwargs=dict(stepsize=0.5, near=0.2, far=1e9, bg=1.0),
        test_tile=tile, device="cpu")
    assert tuple(out["frames"].shape) == (2, 2 * h, 2 * w, 3)
    assert [fn.launches for fn in counts] == [0, 0, 0]
    enc = out["encoder"]
    jax_tiled = jax.jit(lambda pp, a, b: jsr.tile_process(
        fwd, pp, a, b, tile_size=tile, scale=2))
    for fi in range(2):
        ref = jax_tiled(
            p, jnp.asarray(enc["rgb_features"][fi].numpy())[None],
            jnp.asarray(enc["depths"][fi].numpy())[None, ..., None])[0]
        np.testing.assert_allclose(out["frames"][fi].numpy(),
                                   np.clip(np.asarray(ref), 0, 1),
                                   atol=F32_TOL)
    # the tiled decode needs the module itself
    with pytest.raises(ValueError, match="test_tile"):
        pipeline.render_video(
            tdv, tcfg, tp, tb, cuda_sr.prepare_sftnet(
                weights.sftnet_init(num_block=1, scale=1, device="cpu")),
            poses[:1], (h, w), K, data=ttrainer.DataFlags(),
            render_kwargs=dict(stepsize=0.5, near=0.2, far=1e9, bg=1.0),
            test_tile=tile, device="cpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fourk_nerf_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("rel", [
    "chip_smoke.py", "fourk_nerf_torch/ops/s2d.py",
    "fourk_nerf_torch/ops/cuda_sr.py", "fourk_nerf_torch/models/sr_esrnet.py",
    "fourk_nerf_torch/tools/probe_floor.py",
    "fourk_nerf_torch/tools/probe_ops.py"])
def test_module_imports_nothing_of_jax(rel):
    """No import statement of the module, at any depth, names jax, jaxlib,
    flax or the JAX package (strings, such as the file names in
    chip_smoke's kernels line, are not imports); and the walk over the
    whole port, which test_torch_video runs, reaches this file."""
    banned = {"jax", "jaxlib", "flax", "fourk_nerf_tpu"}
    path = os.path.join(REPO, rel)
    assert path in _port_files()
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    seen = 0
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        for name in names:
            seen += 1
            assert name.split(".")[0] not in banned, (rel, name)
    assert seen > 0
