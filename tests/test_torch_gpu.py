"""The port's CUDA kernels vs their plain versions, on the card.

CUDA kernels have no interpret mode, so these run only where a GPU is
present and skip elsewhere. On the machine with the card (which has no JAX,
so the JAX suite's conftest is left out) run
``python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py``.
chip_smoke.py holds the same kernels against their plain versions at the
main path's shapes; these cover the other shapes and options."""

import numpy as np
import pytest
import torch

from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dmpigo, dvgo
from fourk_nerf_torch.ops import box_sweep, cuda_box, cuda_grid, cuda_sr, \
    cuda_sweep, plane_sweep

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def sweep_scene(dev, width, depth, act, scene):
    """A 32x32x16 NDC scene with viewdir and spatial PE. ``sparse``: density
    N(-1, 2), a mask at another resolution than the grid (70% set),
    fast_color_thres 1/80. ``dense``: density N(-3, 1), every voxel in the
    mask, fast_color_thres 0, so every live sample is weighted and each
    warp's queue flushes on almost every plane. ``opaque``: density N(6, 1),
    every voxel in the mask, so every ray saturates within a few planes."""
    cfg = dmpigo.make_config(
        xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
        num_voxels=32 * 32 * 16, mpi_depth=16,
        fast_color_thres=0.0 if scene == "dense" else 1.0 / 80,
        rgbnet_dim=6, rgbnet_width=width, rgbnet_depth=depth, viewbase_pe=4,
        spatial_pe=2, act_type=act)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    mean, std = {"sparse": (-1, 2), "dense": (-3, 1), "opaque": (6, 1)}[scene]
    params["density"] = torch.as_tensor(
        rng.normal(mean, std, params["density"].shape).astype(np.float32),
        device=dev)
    params["k0"] = torch.as_tensor(
        rng.normal(0, 1, params["k0"].shape).astype(np.float32), device=dev)
    mask = rng.uniform(size=(9, 11, 8)) < 0.7
    buffers["mask_cache"] = torch.as_tensor(
        mask if scene == "sparse" else np.ones_like(mask), device=dev)
    return cfg, params, buffers


def sweep_camera(h, w):
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    return K, c2w


@pytest.mark.parametrize("use_bf16,width,depth,act,hw,scene", [
    (False, 32, 3, "lkrelu", (32, 40), "sparse"),  # padded to the 64-wide MLP
    (True, 32, 3, "lkrelu", (32, 40), "sparse"),
    (False, 100, 4, "gauss", (32, 40), "sparse"),  # 128 wide, two hidden layers
    (True, 100, 4, "gauss", (32, 40), "sparse"),   # the same with the bf16 MLP
    (False, 64, 2, "relu", (32, 40), "sparse"),    # no hidden layer
    (True, 64, 3, "relu", (5, 9), "sparse"),       # 45 rays: a partial warp
    (False, 64, 3, "relu", (5, 9), "sparse"),
    (True, 64, 3, "relu", (1, 1), "sparse"),       # one ray
    (True, 64, 3, "lkrelu", (32, 40), "dense"),    # a flush on most planes
    (False, 64, 3, "lkrelu", (32, 40), "dense"),
    (True, 64, 3, "relu", (32, 40), "opaque"),     # every ray stops early
    (True, 128, 3, "relu", (32, 40), "sparse"),    # the width-128 bf16 MLP
    (True, 128, 2, "gauss", (32, 40), "dense"),
])
def test_sweep_kernel_matches_plain(cuda, use_bf16, width, depth, act, hw,
                                    scene):
    """Viewdir and spatial PE; the frame sizes, scenes and MLP widths that
    exercise the kernel's per-warp sample queue (partial warps, a flush on
    most planes, warps that stop early, both MLP widths)."""
    cfg, params, buffers = sweep_scene(cuda, width, depth, act, scene)
    h, w = hw
    K, c2w = sweep_camera(h, w)
    kw = dict(stepsize=1.0, bg=0.5, use_bf16=use_bf16, device=cuda)
    n0 = cuda_sweep.sweep.launches
    got = cuda_sweep.render_frame_cuda(cfg, params, buffers, h, w, K, c2w, **kw)
    assert cuda_sweep.sweep.launches == n0 + 1
    ref = plane_sweep.render_frame(cfg, params, buffers, h, w, K, c2w, **kw)
    torch.cuda.synchronize()
    for k in ("rgb_marched", "depth", "alphainv_last"):
        err = (got[k] - ref[k]).abs()
        assert float((err > 2e-4).float().mean()) < 0.02, k
        assert float(err.max()) < 0.05, k


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("h,w", [(37, 55), (5, 9), (8, 16), (40, 64),
                                 (9, 17), (96, 256), (756, 1008), (800, 800)])
def test_rdb_kernel_matches_plain(cuda, tail, h, w):
    """Frames that do not divide the 8x16 tile, smaller than it, one exact
    tile, one of several whole tiles with interior ones, one a pixel over a
    tile boundary each way, one of 192 tiles (more than the SMs, so a
    persistent block walks several and the weight ring wraps across tiles)
    and the two render cells' frames (1008x756 of the LLFF encoder, 800x800
    of the Blender one): SAME zero padding at every frame edge, the swizzled
    slabs and the streamed weights across tiles, one launch a call."""
    model = weights.sftnet_init(num_block=1, seed=2, device=cuda)
    rng = np.random.default_rng(1)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device=cuda).to(torch.bfloat16)
    x, c, xin = t(h, w, 64), t(h, w, 32), t(h, w, 64)
    wts = cuda_sr.pack_rdb_weights(model.body0.rdb3,
                                   model.body0.sft0 if tail else None)
    n0 = cuda_sr.rdb_apply.launches
    got = cuda_sr.rdb_apply(x, c, wts, xin=xin if tail else None)
    assert cuda_sr.rdb_apply.launches == n0 + 1
    ref = cuda_sr.rdb_plain(x, c, wts, xin=xin if tail else None)
    torch.cuda.synchronize()
    assert float((got.float() - ref.float()).abs().max()) <= 0.05


def _box_scene(cuda, *, rgbnet_dim, rgbnet_direct, width, act="relu",
               world=(24, 20, 16)):
    cfg = dvgo.make_config(
        xyz_min=[-1.0, -0.8, -0.6], xyz_max=[1.0, 0.9, 0.7],
        num_voxels=int(np.prod(world)), num_voxels_base=int(np.prod(world)),
        alpha_init=1e-2, rgbnet_dim=rgbnet_dim, rgbnet_direct=rgbnet_direct,
        rgbnet_width=width, rgbnet_depth=3, fast_color_thres=1e-4,
        act_type=act)
    params, buffers = dvgo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, device=cuda)
    params["density"] = t(rng.normal(0, 2, params["density"].shape)
                          .astype(np.float32))
    params["k0"] = t(rng.normal(0, 1, params["k0"].shape).astype(np.float32))
    buffers["mask_cache"] = t(rng.uniform(size=cfg.world_size) > 0.3)
    return cfg, params, buffers


def _look_at(h, w, angle, dist=2.8, target=(0.0, 0.0, 0.0), focal=0.9):
    """A camera ``dist`` from ``target``, looking at it, rotated by
    ``angle`` (about x, then y), focal length ``focal * w``."""
    ax, ay = angle
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    R = (Ry @ Rx).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:3, :3] = R
    c2w[:3, 3] = np.asarray(target, np.float32) + R @ np.array(
        [0, 0, dist], dtype=np.float32)
    f = focal * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=np.float32)
    return K, c2w


#: a pose along each grid axis and sign (the sweep axis and its flip)
BOX_POSES = [(0.0, 0.0), (0.0, np.pi), (0.0, 0.5 * np.pi),
             (0.0, -0.5 * np.pi), (-0.5 * np.pi, 0.2), (0.5 * np.pi, 0.2)]


def _check_box(cuda, cfg, params, buffers, h, w, angle, use_bf16, **cam):
    K, c2w = _look_at(h, w, angle, **cam)
    kw = dict(stepsize=0.5, near=0.2, bg=0.7, use_bf16=use_bf16, device=cuda)
    n0 = cuda_box.sweep_box.launches
    got = cuda_box.render_frame_box_cuda(cfg, params, buffers, h, w, K, c2w,
                                         **kw)
    assert cuda_box.sweep_box.launches == n0 + 1
    ref = box_sweep.render_frame_box(cfg, params, buffers, h, w, K, c2w, **kw)
    torch.cuda.synchronize()
    assert float((ref["rgb_marched"] - 0.7).abs().max()) > 0.05
    for k in ("rgb_marched", "depth", "alphainv_last"):
        err = (got[k] - ref[k]).abs()
        assert float((err > 2e-4).float().mean()) < 0.02, k
        assert float(err.max()) < 0.05, k


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("rgbnet_dim,rgbnet_direct,width", [
    (0, False, 64),     # no MLP: sigmoid of the three k0 channels
    (6, False, 64),     # residual form, padded 64-wide kernel
    (12, False, 128),   # residual form at width 128
    (12, True, 100),    # direct form, 128-wide kernel with padding
])
def test_box_kernel_matches_plain(cuda, use_bf16, rgbnet_dim, rgbnet_direct,
                                  width):
    cfg, params, buffers = _box_scene(cuda, rgbnet_dim=rgbnet_dim,
                                      rgbnet_direct=rgbnet_direct, width=width)
    _check_box(cuda, cfg, params, buffers, 20, 28, (0.4, 0.3), use_bf16)


@pytest.mark.parametrize("angle", BOX_POSES)
def test_box_kernel_every_axis_and_sign(cuda, angle):
    cfg, params, buffers = _box_scene(cuda, rgbnet_dim=6, rgbnet_direct=False,
                                      width=32, act="lkrelu")
    _check_box(cuda, cfg, params, buffers, 16, 24, angle, False)
    _check_box(cuda, cfg, params, buffers, 16, 24, angle, True)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_box_kernel_coarse_model_matches_plain(cuda, use_bf16):
    """The coarse stage's model (no rgbnet: the sigmoid of a 3-channel k0;
    the near-camera voxels masked out) rendered by ``render_viewpoints``
    takes the box kernel, one launch a frame, and agrees with the plain
    version."""
    from fourk_nerf_torch.train import trainer
    cfg, params, buffers = _box_scene(cuda, rgbnet_dim=0,
                                      rgbnet_direct=False, width=64)
    params = dvgo.maskout_near_cam_vox(cfg, params, [[0.0, 0.0, 0.9]], 0.5)
    K, c2w = _look_at(20, 28, (0.4, 0.3))
    n0 = cuda_box.sweep_box.launches
    res = trainer.render_viewpoints(
        dvgo, cfg, params, buffers, np.stack([c2w, c2w]),
        np.array([[20, 28]] * 2), np.stack([K, K]),
        data=trainer.DataFlags(), render_kwargs=dict(
            stepsize=0.5, near=0.2, far=1e9, bg=0.7),
        gt_imgs=None if use_bf16 else [np.zeros((20, 28, 3))] * 2,
        verbose=False, device=cuda)
    assert res["path"] == "box" and cuda_box.sweep_box.launches == n0 + 2
    ref = box_sweep.render_frame_box(cfg, params, buffers, 20, 28, K, c2w,
                                     stepsize=0.5, near=0.2, bg=0.7,
                                     use_bf16=use_bf16, device=cuda)
    torch.cuda.synchronize()
    assert float((ref["rgb_marched"] - 0.7).abs().max()) > 0.05
    err = (res["rgbs"][0] - ref["rgb_marched"]).abs()
    assert float((err > 2e-4).float().mean()) < 0.02
    assert float(err.max()) < 0.05


def test_box_kernel_frame_smaller_than_a_block(cuda):
    """5x7 rays: one partly filled thread block."""
    cfg, params, buffers = _box_scene(cuda, rgbnet_dim=6, rgbnet_direct=True,
                                      width=64)
    _check_box(cuda, cfg, params, buffers, 5, 7, (0.4, 0.3), True)


def _skip_scene(cuda, kind, rgbnet):
    """Scenes built to break the box kernel's empty-space skipping (blocks
    of B = ``cuda_box.OCC_BLOCK`` voxels): ``shell``, the one-voxel shell
    of the cube [B, 2B-1]^3 in a (3B)^3 grid, its faces on block
    boundaries whichever way the sweep runs; ``corner``, one voxel at
    (B, B, B), a block corner, seen by a camera aimed at it whose frame
    spans about 8 voxels; ``grid37``, a 37^3 grid (no multiple of the
    block) with a sparse random mask. Density N(4, 2), so the mask decides
    what is seen; rgbnet ``none``, ``residual`` or ``direct``."""
    B = cuda_box.OCC_BLOCK
    G = 37 if kind == "grid37" else 3 * B
    cfg = dvgo.make_config(
        xyz_min=[-1.0] * 3, xyz_max=[1.0] * 3, num_voxels=int(G ** 3 * 1.001),
        num_voxels_base=int(G ** 3 * 1.001), alpha_init=1e-2,
        rgbnet_dim=0 if rgbnet == "none" else 12,
        rgbnet_direct=rgbnet == "direct", rgbnet_width=64, rgbnet_depth=3,
        fast_color_thres=1e-4)
    assert tuple(cfg.world_size) == (G, G, G)
    params, buffers = dvgo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.default_rng(G)
    t = lambda a: torch.as_tensor(a, device=cuda)
    params["density"] = t(rng.normal(4, 2, params["density"].shape)
                          .astype(np.float32))
    params["k0"] = t(rng.normal(0, 1, params["k0"].shape).astype(np.float32))
    mask = np.zeros((G, G, G), bool)
    if kind == "shell":
        mask[B:2 * B, B:2 * B, B:2 * B] = True
        mask[B + 1:2 * B - 1, B + 1:2 * B - 1, B + 1:2 * B - 1] = False
    elif kind == "corner":
        mask[B, B, B] = True
    else:
        mask = rng.uniform(size=(G, G, G)) < 0.01
        mask[20:23, 5:7, 30:33] = True
    buffers["mask_cache"] = t(mask)
    return cfg, params, buffers


@pytest.mark.parametrize("rgbnet", ["none", "residual", "direct"])
@pytest.mark.parametrize("kind", ["shell", "corner", "grid37"])
def test_box_kernel_skip_scenes(cuda, kind, rgbnet):
    """Every sweep axis and sign, with rays exactly along the grid axes and
    tilted by 1e-3 rad (almost parallel to the block faces), bf16 and
    float32 grids; every frame sees the scene."""
    cfg, params, buffers = _skip_scene(cuda, kind, rgbnet)
    cam = {}
    if kind == "corner":
        B, G = cuda_box.OCC_BLOCK, cfg.world_size[0]
        cam = dict(target=[-1.0 + 2.0 * B / (G - 1)] * 3, focal=8.0)
    for ax, ay in BOX_POSES:
        for tilt in (0.0, 1e-3):
            for use_bf16 in (False, True):
                _check_box(cuda, cfg, params, buffers, 24, 32,
                           (ax + tilt, ay + tilt), use_bf16, **cam)


def test_box_kernel_refuses_a_native_resolution_mask(cuda):
    cfg, params, buffers = _box_scene(cuda, rgbnet_dim=6, rgbnet_direct=False,
                                      width=64)
    buffers["mask_cache"] = buffers["mask_cache"][::2, ::2, ::2].contiguous()
    K, c2w = _look_at(8, 8, (0.4, 0.3))
    with pytest.raises(ValueError):
        cuda_box.render_frame_box_cuda(cfg, params, buffers, 8, 8, K, c2w,
                                       stepsize=0.5, near=0.2, bg=0.0,
                                       device=cuda)


@pytest.mark.parametrize("h,w", [(37, 55), (5, 9), (36, 60), (75, 130)])
def test_rrdb_kernel_matches_plain(cuda, h, w):
    """Frames that divide no tile and no 36x60 region, one smaller than a
    tile, one exact region, one of several regions."""
    model = weights.sftnet_init(num_block=1, seed=2, device=cuda)
    rng = np.random.default_rng(1)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device=cuda).to(torch.bfloat16)
    x, c = t(h, w, 64), t(h, w, 32)
    wts = cuda_sr.pack_rrdb_weights(model.body0)
    n0 = cuda_sr.rrdb_apply.launches
    got = cuda_sr.rrdb_apply(x, c, wts)
    assert cuda_sr.rrdb_apply.launches == n0 + 1
    ref = cuda_sr.rrdb_plain(x, c, wts)
    torch.cuda.synchronize()
    assert float((got.float() - ref.float()).abs().max()) <= 0.05


@pytest.mark.parametrize("h2,w2", [(45, 70), (48, 64), (1, 1), (5, 9),
                                   (8, 16), (17, 33), (7, 13), (8, 14),
                                   (9, 15), (9, 14), (8, 15), (17, 29)])
def test_uptail_kernel_matches_plain(cuda, h2, w2):
    """The odd size of the JAX suite's test, an even one, a single pixel,
    sizes under, at and one 2x-map pixel past one 16x28 output tile (8x14
    pixels of the 2x map) in each direction and in both, two tiles and one
    pixel, and the old 16x32 tile's edges: SAME zero padding at every frame
    edge, for every stage."""
    model = weights.sftnet_init(num_block=1, seed=2, device=cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(1, h2, w2, 64)).astype(np.float32),
                        device=cuda)
    wts = cuda_sr.pack_uptail_weights(model)
    n0 = cuda_sr.uptail_apply.launches
    got = cuda_sr.uptail_apply(x, wts)
    assert cuda_sr.uptail_apply.launches == n0 + 1
    ref = cuda_sr.uptail_plain(x, wts)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (1, 2 * h2, 2 * w2, 3)
    assert float((got - ref).abs().max()) <= 0.03
    torch.testing.assert_close(got, got.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_uptail_apply_refuses_a_bad_input(cuda):
    model = weights.sftnet_init(num_block=1, seed=2, device=cuda)
    wts = cuda_sr.pack_uptail_weights(model)
    with pytest.raises(ValueError):
        cuda_sr.uptail_apply(torch.zeros((4, 4, 64), device=cuda), wts)
    with pytest.raises(ValueError):
        cuda_sr.uptail_apply(torch.zeros((1, 4, 4, 64)), wts)  # CPU input


def test_probe_floor_checksums(cuda):
    """Every floor probe reproduces its checksum (run raises otherwise) and
    reports a positive time."""
    from fourk_nerf_torch.tools import probe_floor
    probe_floor.run.launches = 0
    res = probe_floor.run(device=cuda, reps=1)
    # a warm-up and one timed launch of each of the six probes
    assert probe_floor.run.launches == res["launches"] == 12
    assert res["library_ms"] > 0
    assert set(res["probes"]) == {"empty", "empty_sync", "smem_read",
                                  "dyn_window", "window_mma", "copy_ring"}
    assert all(p["ms"] > 0 for p in res["probes"].values())


def test_probe_ops_limits(cuda):
    """Each of the six constructs is within its limit (run raises
    otherwise); the four data movements are exact."""
    from fourk_nerf_torch.tools import probe_ops
    probe_ops.run.launches = 0
    res = probe_ops.run(device=cuda)
    assert len(res["probes"]) == 6
    # one checked and ten timed launches of each
    assert probe_ops.run.launches == res["launches"] == 66
    assert all(p["library_ms"] > 0 for p in res["probes"].values())
    for name in ("r3_bcast", "strided_row", "repeat_rows", "block_reduce"):
        assert res["probes"][name]["max_err"] == 0.0


# --- the encoder's training step on the card (plain torch ops) ------------

def test_train_steps_cuda_match_cpu(cuda, tmp_path):
    """Ten steps of the tiny CPU-test scene on the card and on the CPU:
    per-step losses within 1e-4 relative (the index backward's atomics on
    the card sum in another order)."""
    import os
    import types

    from fourk_nerf_torch import config
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import trainer

    class W:
        def __init__(self):
            self.loss = []

        def scalar(self, tag, value, step):
            if tag == "train/loss":
                self.loss.append(value)

    root = os.path.join(os.path.dirname(__file__), "..")
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = tiny_scene.apply_overrides(config.load_config(os.path.join(
            root, "fourk_nerf_torch", "configs", "llff",
            "fern_lg_pretrain.py")), str(tmp_path), dev)
        cfg.data.rand_bkgd = True
        w = W()
        args = types.SimpleNamespace(seed=0, no_reload=True,
                                     no_reload_optimizer=False, ft_path="",
                                     i_print=1, i_val=0, i_weights=0)
        trainer.train(args, cfg, tiny_scene.scene(), writer=w, device=dev)
        out[dev] = np.array(w.loss)
    assert len(out["cpu"]) == 10
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)


def _grid64(seed, c):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (64, 64, 64, c)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_adam_cuda_matches_cpu(cuda, masked):
    """MaskedAdam at a 64^3 grid (10 channels, three steps): params and
    moments within 1e-6 of the CPU update."""
    from fourk_nerf_torch.train import optim

    p0 = {"density": _grid64(0, 1), "k0": _grid64(1, 9)}
    grads = [{k: np.where(np.random.default_rng(s).uniform(size=v.shape)
                          < 0.5, 0, _grid64(s + 10, v.shape[-1]))
              .astype(np.float32) for k, v in p0.items()} for s in range(3)]
    skip = frozenset(p0) if masked else frozenset()
    res = {}
    for dev in ("cpu", cuda):
        p = weights.to_torch(p0, dev)
        st = optim.init_state(p)
        for g in grads:
            optim.apply_updates(p, weights.to_torch(g, dev), st,
                                {"density": 0.1, "k0": 0.1},
                                skip_zero_grad=skip)
        res[str(dev)] = (p, st)
    for k in p0:
        for a, b in ((res["cpu"][0][k], res["cuda"][0][k]),
                     (res["cpu"][1]["exp_avg"][k],
                      res["cuda"][1]["exp_avg"][k]),
                     (res["cpu"][1]["exp_avg_sq"][k],
                      res["cuda"][1]["exp_avg_sq"][k])):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("sparse", [False, True])
def test_total_variation_grad_cuda_matches_cpu(cuda, sparse):
    """The TV gradient at a 64^3 grid, 9 channels: within 1e-7 of the CPU
    (the same elementwise float32 ops)."""
    from fourk_nerf_torch.ops import render

    grid = _grid64(2, 9)
    g = np.where(np.random.default_rng(3).uniform(size=grid.shape) < 0.5, 0,
                 1).astype(np.float32)
    out = [render.total_variation_grad(
        torch.as_tensor(grid, device=d), 1e-3, 1e-3, 2e-3,
        torch.as_tensor(g, device=d) if sparse else None).cpu().numpy()
        for d in ("cpu", cuda)]
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-7)


# --- the grid update kernels (csrc/grid_update.cu) against their plain
# versions on the card, bit for bit ------------------------------------------

GRID_SHAPES = [(1, 1, 1), (2, 3, 1), (3, 1, 2), (1, 2, 3), (5, 7, 9),
               (17, 13, 11)]


def _grid_case(dev, xyz, c, zero_share, seed, misaligned=False):
    """A grid and a gradient on ``dev``, the gradient zero on
    ``zero_share`` of its entries (a third of those -0.0); differences up
    to ~6, so some clip. ``misaligned``: both views start one float into
    their storage, which the kernels take entry by entry."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = tuple(xyz) + (c,)
    n = int(np.prod(shape))

    def make(scale):
        buf = torch.randn(n + 1, generator=g, device=dev) * scale
        return (buf[1:] if misaligned else buf[:n]).view(shape)

    grid, grad = make(2.0), make(1e-3)
    r = torch.rand(shape, generator=g, device=dev)
    grad[r < zero_share] = 0.0
    grad[r < zero_share / 3] = -0.0
    return grid, grad


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _tv_plain(grid, grad, w, dense):
    from fourk_nerf_torch.ops import render
    return grad + render.total_variation_grad(grid, *w,
                                              None if dense else grad)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("zero_share", [0.0, 0.999, 1.0])
@pytest.mark.parametrize("c", [1, 3, 9, 12])
@pytest.mark.parametrize("xyz", GRID_SHAPES)
def test_tv_add_grad_kernel_matches_plain(cuda, xyz, c, zero_share, dense):
    """``tv_add_grad_`` against ``grad + total_variation_grad`` on the card:
    extents 1, 2, 3 and odd on each axis, 1-12 channels, gradients all
    non-zero, 99.9% and all zero. Equal bit for bit, except that the plain
    sparse TV turns a -0.0 gradient into +0.0 and the kernel leaves it."""
    grid, grad = _grid_case(cuda, xyz, c, zero_share, seed=c)
    w = (0.3, 0.5, 0.7)
    want = _tv_plain(grid, grad, w, dense)
    got = grad.clone()
    n0 = cuda_grid.tv_add_grad_.launches
    assert cuda_grid.tv_add_grad_(grid, got, *w, dense) is got
    assert cuda_grid.tv_add_grad_.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # +0.0 == -0.0, no NaN
    if not dense:
        assert _same_bits(got[grad == 0], grad[grad == 0])
        assert _same_bits(got[grad != 0], want[grad != 0])
    else:
        assert _same_bits(got, want)


@pytest.mark.parametrize("dense", [False, True])
def test_tv_add_grad_kernel_misaligned(cuda, dense):
    """Views that start one float into their storage: the entry-by-entry
    kernel, the same bits."""
    grid, grad = _grid_case(cuda, (5, 7, 9), 9, 0.7, seed=3, misaligned=True)
    assert grad.data_ptr() % 16 != 0
    w = (1e-3, 1e-3, 2e-3)
    want = _tv_plain(grid, grad, w, dense)
    got = grad.new_empty(grad.numel() + 1)[1:].view(grad.shape).copy_(grad)
    cuda_grid.tv_add_grad_(grid, got, *w, dense)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _adam_plain(p, g, m, v, step_size, masked, plr):
    from fourk_nerf_torch.train import optim
    optim.masked_adam_plain(p.view(-1), g.reshape(-1), m.view(-1),
                            v.view(-1), step_size, masked,
                            None if plr is None else plr.reshape(-1))


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("use_plr", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("zero_share", [0.0, 0.999, 1.0])
@pytest.mark.parametrize("xyz,c", [((1, 1, 1), 1), ((2, 3, 1), 3),
                                   ((5, 7, 9), 9), ((17, 13, 11), 12)])
def test_masked_adam_kernel_matches_plain(cuda, xyz, c, zero_share, masked,
                                          use_plr, misaligned):
    """``masked_adam_`` against ``optim.masked_adam_plain`` on the card, two
    chained steps (the second on the first's moments): params and moments
    bit for bit; ``touched`` counts the entries with a non-zero gradient
    (every entry unmasked)."""
    p0, _ = _grid_case(cuda, xyz, c, 0.0, seed=1, misaligned=misaligned)
    plr = (torch.rand(p0.shape, device=cuda) + 0.5) if use_plr else None
    ref = [p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)]
    got = [t.clone() for t in ref]
    if misaligned:
        got = [t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t)
               for t in got]
    for step, ss in enumerate((0.01, 0.0037)):
        _, g = _grid_case(cuda, xyz, c, zero_share, seed=10 + step)
        _adam_plain(*ref[:1], g, *ref[1:], ss, masked, plr)
        touched = torch.zeros((), dtype=torch.int64, device=cuda)
        n0 = cuda_grid.masked_adam_.launches
        cuda_grid.masked_adam_(got[0], g, got[1], got[2], ss, masked, plr,
                               touched)
        assert cuda_grid.masked_adam_.launches == n0 + 1
        torch.cuda.synchronize()
        want_n = int((g != 0).sum()) if masked else g.numel()
        assert int(touched) == want_n
    for a, b in zip(got, ref):
        assert _same_bits(a, b)


def test_grid_update_kernels_at_the_pretrain_shape(cuda):
    """The pretrain's k0 grid, [363, 405, 256, 9] (338.7M entries), a
    gradient 75% zero: sparse TV, then masked Adam on its result, both
    against the plain versions, bit for bit (±0 aside in the skipped
    gradient)."""
    grid, grad = _grid_case(cuda, (363, 405, 256), 9, 0.75, seed=5)
    w = (2.2e-4, 2.2e-4, 1.3e-4)
    want = _tv_plain(grid, grad, w, False)
    cuda_grid.tv_add_grad_(grid, grad, *w, False)
    torch.cuda.synchronize()
    assert torch.equal(grad, want)
    del want
    m = torch.zeros_like(grid)
    v = torch.zeros_like(grid)
    p = grid.clone()
    _adam_plain(grid, grad, m, v, 1e-3, True, None)
    m2, v2 = torch.zeros_like(p), torch.zeros_like(p)
    touched = torch.zeros((), dtype=torch.int64, device=cuda)
    cuda_grid.masked_adam_(p, grad, m2, v2, 1e-3, True, None, touched)
    torch.cuda.synchronize()
    assert int(touched) == int((grad != 0).sum())
    for a, b in ((p, grid), (m2, m), (v2, v)):
        assert _same_bits(a, b)


@pytest.mark.parametrize("dense", [False, True])
def test_tv_add_grad_kernel_64bit_indices(cuda, dense):
    """A grid of more than 2^31 entries, [2049, 1024, 1024, 1], takes the
    64-bit index path: the last ten X planes (entry 2^31 starts plane 2048)
    against the plain TV of a slab with one more plane, bit for bit (±0
    aside in the skipped gradient); sparse TV leaves the zero gradient
    before the slab untouched."""
    shape = (2049, 1024, 1024, 1)
    assert int(np.prod(shape)) > 2 ** 31
    g = torch.Generator(device=cuda).manual_seed(7)
    grid = torch.randn(shape, generator=g, device=cuda)
    grad = torch.zeros(shape, device=cuda)
    _, grad[2038:] = _grid_case(cuda, (11, 1024, 1024), 1, 0.5, seed=8)
    w = (0.3, 0.5, 0.7)
    want = _tv_plain(grid[2038:], grad[2038:], w, dense)[1:]
    cuda_grid.tv_add_grad_(grid, grad, *w, dense)
    torch.cuda.synchronize()
    assert torch.equal(grad[2039:], want)
    if not dense:
        assert not bool(grad[:2038].any())


def test_grid_update_kernels_refuse(cuda):
    """A CUDA param or moment that is not contiguous float32 raises, as do
    mismatched shapes; a refused call counts no launch."""
    p = torch.zeros(4, 5, 6, 2, device=cuda)
    g = torch.ones_like(p)
    n_tv, n_adam = cuda_grid.tv_add_grad_.launches, \
        cuda_grid.masked_adam_.launches
    bad = {"strided": p.transpose(0, 1), "float64": p.double(),
           "bfloat16": p.bfloat16()}
    for name, t in bad.items():
        for args in ((t, g, p.clone(), p.clone()), (p, g, t, p.clone()),
                     (p, g, p.clone(), t)):
            with pytest.raises(ValueError, match="contiguous float32"):
                cuda_grid.masked_adam_(*args, 0.1, True)
        with pytest.raises(ValueError):
            cuda_grid.tv_add_grad_(t, g, 1.0, 1.0, 1.0, False)
    with pytest.raises(ValueError):
        cuda_grid.tv_add_grad_(p, g[:, :, :3], 1.0, 1.0, 1.0, False)
    with pytest.raises(ValueError):
        cuda_grid.masked_adam_(p, g, p.clone(), p.clone(), 0.1, True,
                               touched=torch.zeros((), device=cuda))
    assert cuda_grid.tv_add_grad_.launches == n_tv
    assert cuda_grid.masked_adam_.launches == n_adam


# --- the joint trainer on the card, and full float32 without TF32 ---------

@pytest.fixture
def cuda_tf32_on():
    """The card with TF32 forced on for float32 matmuls and cuDNN convs (a
    user's process has it on for convs by default); the test itself turns
    nothing off. The settings are restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        saved


def _joint_tiny(dev):
    cfg = dmpigo.make_config(
        xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
        num_voxels=32 * 32 * 8, mpi_depth=8, rgbnet_dim=6, rgbnet_width=16,
        fast_color_thres=1.0 / 40)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator().manual_seed(1)
    params["density"] = torch.randn(params["density"].shape,
                                    generator=g).to(dev)
    params["k0"] = torch.randn(params["k0"].shape, generator=g).to(dev)
    return cfg, params, buffers


def _sftnet(dev, **kw):
    from fourk_nerf_torch.models import sr_esrnet
    model = sr_esrnet.SFTNet(**kw)
    sr_esrnet.init_like_jax(model, torch.Generator().manual_seed(2))
    return model.to(dev)


def test_float32_video_decode_ignores_tf32(cuda_tf32_on):
    """``render_video``'s float32 branch (an SFTNet of another geometry
    than the kernels') on the card, against the same decode on the CPU:
    within 1e-5, where the same forward under TF32 is off by more."""
    from fourk_nerf_torch import pipeline
    from fourk_nerf_torch.train import trainer
    dev = cuda_tf32_on
    cfg, params, buffers = _joint_tiny(dev)
    sr = _sftnet(dev, num_feat=32, num_block=2, num_grow_ch=16)
    assert not cuda_sr.fits_kernels(sr)
    K, c2w = sweep_camera(48, 64)
    res = pipeline.render_video(
        dmpigo, cfg, params, buffers, sr, c2w[None], np.array([48, 64]), K,
        data=trainer.DataFlags(ndc=True),
        render_kwargs={"stepsize": 1.0, "bg": 0.0}, device=dev)
    feat = res["encoder"]["rgb_features"][0][None]
    cond = res["encoder"]["depths"][0][None, ..., None]
    sr_cpu = _sftnet("cpu", num_feat=32, num_block=2, num_grow_ch=16)
    with torch.no_grad():
        want = sr_cpu(feat.cpu(), cond.cpu())[0].clamp(0, 1)
        tf32 = sr(feat, cond)[0].clamp(0, 1).cpu()  # TF32 on: no entry point
    err = float((res["frames"][0].cpu() - want).abs().max())
    err_tf32 = float((tf32 - want).abs().max())
    assert err <= 1e-5, err
    assert err_tf32 > 1e-5, err_tf32  # the check sees TF32


def test_joint_step_ignores_tf32(cuda_tf32_on):
    """One joint step (gather render, SFTNet forward and backward, both
    MaskedAdams) on the card against the CPU: loss within 1e-5 relative,
    the generator's gradients (its first moments) within 1e-4 of each
    leaf's largest entry."""
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.ops import rays
    from fourk_nerf_torch.train import checkpoints, optim, sr_trainer
    out = {}
    for dev in ("cpu", cuda_tf32_on):
        cfg, params, buffers = _joint_tiny(dev)
        sr = _sftnet(dev, num_feat=32, num_block=1, num_grow_ch=16)
        ct = ConfigDict(dict(weight_main=1.0, weight_entropy_last=1e-3,
                             weight_distortion=0.01, weight_rgbper=0.01,
                             weight_tv_density=0, weight_tv_k0=0))
        step = sr_trainer.SRTrainStep(
            dmpigo, cfg, ct, ConfigDict({}),
            render_kwargs={"stepsize": 1.0, "bg": 0.0, "ndc_planes": True},
            skip_zero_grad={"density", "k0"}, sr_model=sr, n_views=1,
            patch=8, sr_ratio=4)
        K, c2w = sweep_camera(32, 40)
        ro, rd, vd = (t[10:18, 12:20].reshape(-1, 3) for t in
                      rays.get_rays_of_a_view(32, 40, K, c2w, ndc=True,
                                              inverse_y=False, flip_x=False,
                                              flip_y=False, device=dev))
        g = torch.Generator().manual_seed(3)
        batch = (ro, rd, vd, torch.rand(64, 3, generator=g).to(dev),
                 torch.rand(1024, 3, generator=g).to(dev))
        sr_opt = optim.init_state({"srnet": weights.sftnet_params(sr)})
        loss, _, _ = step(params, buffers, optim.init_state(params), sr_opt,
                          batch, {"enc": {"k0": 0.1, "density": 0.1},
                                  "srnet": 1e-3},
                          apply_tv=False, tv_dense=False)
        out[str(dev)] = (loss.item(), checkpoints.tree_to_flat_dict(
            sr_opt["exp_avg"]))
    (lc, mc), (lg, mg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k, want in mc.items():
        got = mg[k].cpu()
        tol = 1e-4 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, k


def test_graphed_joint_steps_match_op_by_op(cuda):
    """Three joint steps whose generator forward, backward and Adam replay
    CUDA graphs against the same steps run op by op: the first loss bit for
    bit, the generator's first gradient (its first moment) within 1e-5 of
    each leaf's largest entry and the later losses within 1e-5 relative.
    Not bit for bit: cuDNN's weight gradient and the encoder's gathers sum
    with atomic adds, in another order on every run, graphed or not; a
    generator update left out moves the later losses by far more."""
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.ops import rays
    from fourk_nerf_torch.train import checkpoints, optim, sr_trainer
    out = {}
    for graphed in (False, True):
        cfg, params, buffers = _joint_tiny(cuda)
        sr = _sftnet(cuda, num_feat=32, num_block=1, num_grow_ch=16)
        ct = ConfigDict(dict(weight_main=1.0, weight_entropy_last=1e-3,
                             weight_distortion=0.01, weight_rgbper=0.01,
                             weight_tv_density=0, weight_tv_k0=0))
        step = sr_trainer.SRTrainStep(
            dmpigo, cfg, ct, ConfigDict({}),
            render_kwargs={"stepsize": 1.0, "bg": 0.0, "ndc_planes": True},
            skip_zero_grad={"density", "k0"}, sr_model=sr, n_views=1,
            patch=8, sr_ratio=4)
        step.graph_generator = graphed
        K, c2w = sweep_camera(32, 40)
        full = rays.get_rays_of_a_view(32, 40, K, c2w, ndc=True,
                                       inverse_y=False, flip_x=False,
                                       flip_y=False, device=cuda)
        g = torch.Generator().manual_seed(3)
        enc_opt = optim.init_state(params)
        sr_opt = optim.init_state({"srnet": weights.sftnet_params(sr)})
        losses = []
        for i in range(3):
            r, c = 4 + 6 * i, 8 + 5 * i
            ro, rd, vd = (t[r:r + 8, c:c + 8].reshape(-1, 3) for t in full)
            batch = (ro, rd, vd, torch.rand(64, 3, generator=g).to(cuda),
                     torch.rand(1024, 3, generator=g).to(cuda))
            loss, _, _ = step(params, buffers, enc_opt, sr_opt, batch,
                              {"enc": {"k0": 0.1, "density": 0.1},
                               "srnet": 1e-2},
                              apply_tv=False, tv_dense=False)
            losses.append(loss.item())
            if i == 0:
                first = {k: v.clone() for k, v in
                         checkpoints.tree_to_flat_dict(
                             sr_opt["exp_avg"]).items()}
        assert bool(step._graphs) == graphed
        out[graphed] = (losses, first)
    (l0, m0), (l1, m1) = out[False], out[True]
    assert l1[0] == l0[0]
    np.testing.assert_allclose(l1[1:], l0[1:], rtol=1e-5)
    for k, want in m0.items():
        tol = 1e-5 * float(want.abs().max())
        assert float((m1[k] - want).abs().max()) <= tol, k


def test_graphed_tree_update_equals_op_by_op(cuda):
    """``optim.GraphedTreeUpdate`` over three steps of changing step sizes
    equals ``optim._update_tree`` bit for bit, on gradients of other
    strides than their leaves, and is captured again when a gradient is
    another tensor."""
    from fourk_nerf_torch.train import optim
    g = torch.Generator().manual_seed(6)

    def tree():
        return {"a": torch.randn((16, 3, 3, 3), generator=g).to(cuda),
                "b": {"w": torch.randn((16, 16, 1, 1), generator=g).to(cuda),
                      "bias": torch.randn((16,), generator=g).to(cuda)}}
    p = tree()
    p2 = {"a": p["a"].clone(), "b": {k: v.clone() for k, v in p["b"].items()}}
    m, v = optim._zeros_like_tree(p), optim._zeros_like_tree(p)
    m2, v2 = optim._zeros_like_tree(p), optim._zeros_like_tree(p)
    grads = tree()
    grads["a"] = grads["a"].to(memory_format=torch.channels_last)
    upd = optim.GraphedTreeUpdate()
    for i, lr in enumerate((1e-3, 5e-4, 2e-4)):
        fresh = tree()
        for path, leaf in optim._leaves(fresh):
            optim._at(grads, path).copy_(leaf)
        optim._update_tree(p, grads, m, v, lr)
        upd(p2, grads, m2, v2, lr)
        graph = upd.graph
    for path, leaf in optim._leaves(p):
        assert torch.equal(optim._at(p2, path), leaf), path
        assert torch.equal(optim._at(m2, path), optim._at(m, path)), path
    grads["b"]["bias"] = grads["b"]["bias"].clone()
    upd(p2, grads, m2, v2, 1e-4)
    assert upd.graph is not graph


def test_sweep_cumprod_gradient_cuda_is_torchs(cuda):
    """The sweep's transmittance product on the card takes torch's own
    cumprod gradient bit for bit, with and without zero factors, and reads
    nothing back from the device."""
    from fourk_nerf_torch.ops import plane_sweep
    g = torch.Generator().manual_seed(7)
    for share in (0.0, 0.05):
        x = torch.rand((64, 4, 256), generator=g)
        x[torch.rand(x.shape, generator=g) < share] = 0.0
        x, grad = x.to(cuda), torch.randn(x.shape, generator=g).to(cuda)
        a = x.clone().requires_grad_(True)
        b = x.clone().requires_grad_(True)
        want, = torch.autograd.grad(torch.cumprod(a, -1), a, grad)
        out = plane_sweep._Cumprod.apply(b)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, = torch.autograd.grad(out, b, grad)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)


def test_joint_steps_cuda_match_cpu(cuda, tmp_path):
    """Six joint steps of the tiny joint scene (``tools/tiny_scene.py``,
    the full-grid sweep with TV, then the grid window) on the card and on
    the CPU: every loss term at every step within 1e-4 relative."""
    import os
    import types

    from fourk_nerf_torch import config
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import sr_trainer

    class W:
        def __init__(self):
            self.rows = {}

        def scalar(self, tag, value, step):
            self.rows.setdefault(tag, []).append(value)

    root = os.path.join(os.path.dirname(__file__), "..")
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = tiny_scene.apply_overrides(config.load_config(os.path.join(
            root, "fourk_nerf_torch", "configs", "llff",
            "fern_lg_joint_l1.py")), str(tmp_path), dev,
            tiny_scene.JOINT_OVERRIDES)
        w = W()
        args = types.SimpleNamespace(seed=0, no_reload=True, ftdv_path="",
                                     ftsr_path="", no_reload_optimizer=False,
                                     i_print=1, i_val=0, i_weights=0,
                                     test_tile=0)
        sr_trainer.scene_rep_reconstruction_sr_patch(
            args, cfg, cfg.fine_model_and_render, cfg.fine_train,
            *(np.array(v) for v in tiny_scene.SR_BOX), tiny_scene.sr_scene(),
            stage="fine", writer=w, device=dev)
        out[dev] = w.rows
    assert set(out["cuda"]) == set(out["cpu"])
    for k, want in out["cpu"].items():
        assert len(want) == 6
        np.testing.assert_allclose(out["cuda"][k], want, rtol=1e-4,
                                   err_msg=k)


def test_gan_joint_steps_cuda_match_cpu(cuda, tmp_path):
    """Six steps of the tiny joint scene on the GAN config (the
    discriminator, the perceptual and style terms on the fixed-seed random
    VGG19 tower) on the card and on the CPU: every loss term at every step,
    the discriminator's included, within 1e-4 relative, or 1e-8 absolute
    for a term near zero: the style term (~1e-6 here) is the L1 between
    two nearly equal Gram matrices, so float32 rounding of the Grams is
    ~1e-4 of it by step 5 (1.5e-4, 1.3e-10 absolute, on the card)."""
    import os
    import types

    from fourk_nerf_torch import config
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import sr_trainer

    class W:
        def __init__(self):
            self.rows = {}

        def scalar(self, tag, value, step):
            self.rows.setdefault(tag, []).append(value)

    root = os.path.join(os.path.dirname(__file__), "..")
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = tiny_scene.apply_overrides(config.load_config(os.path.join(
            root, "fourk_nerf_torch", "configs", "llff",
            "fern_lg_joint_l1_gan.py")), str(tmp_path), dev,
            tiny_scene.JOINT_OVERRIDES)
        cfg.fine_train.allow_random_vgg = True
        w = W()
        args = types.SimpleNamespace(seed=0, no_reload=True, ftdv_path="",
                                     ftsr_path="", no_reload_optimizer=False,
                                     i_print=1, i_val=0, i_weights=0,
                                     test_tile=0)
        sr_trainer.scene_rep_reconstruction_sr_patch(
            args, cfg, cfg.fine_model_and_render, cfg.fine_train,
            *(np.array(v) for v in tiny_scene.SR_BOX), tiny_scene.sr_scene(),
            stage="fine", writer=w, device=dev)
        out[dev] = w.rows
    assert set(out["cuda"]) == set(out["cpu"])
    assert {"train/loss_g", "train/loss_pcp", "train/loss_style",
            "train/loss_d_real", "train/loss_d_fake"} <= set(out["cpu"])
    for k, want in out["cpu"].items():
        assert len(want) == 6
        np.testing.assert_allclose(out["cuda"][k], want, rtol=1e-4,
                                   atol=1e-8, err_msg=k)


def test_dcvgo_forward_and_gradients_cuda_match_cpu(cuda):
    """DirectContractedVoxGO's forward and the gradients of its training
    loss (near-clip and distortion terms on) on the card against the CPU,
    a 24^3 grid, 1024 rays of a 32x32 view from inside the foreground
    cube: outputs 1e-4, gradients within 1e-4 of each leaf's largest
    entry, the keep mask's differing share under 1% (the spacing filter
    flips on a one-ulp change of a crowded outer sample's distance)."""
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.models import dcvgo
    from fourk_nerf_torch.ops import rays as ray_ops
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import losses

    cfg = dcvgo.make_config(
        xyz_min=[-4.4, -4.6, -4.3], xyz_max=[4.6, 4.4, 4.7],
        num_voxels=24 ** 3, num_voxels_base=24 ** 3, alpha_init=1e-2,
        fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_width=16)
    rng = np.random.default_rng(0)
    params, buffers = dcvgo.init(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params["density"] = torch.as_tensor(rng.normal(
        0, 2, params["density"].shape).astype(np.float32))
    params["k0"] = torch.as_tensor(rng.normal(
        0, 1, params["k0"].shape).astype(np.float32))
    f = tiny_scene.blender_focal(32)
    K = np.array([[f, 0, 16], [0, f, 16], [0, 0, 1]], np.float32)
    rays = [t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
        32, 32, K, tiny_scene.bounded_poses(3)[2], ndc=False,
        inverse_y=False, flip_x=False, flip_y=False, device="cpu")]
    target = torch.as_tensor(rng.uniform(0, 1, (1024, 3)).astype(np.float32))
    train = ConfigDict(dict(weight_main=1.0, weight_entropy_last=0.01,
                            weight_nearclip=0.5, weight_distortion=0.01,
                            weight_rgbper=0.01))
    res = {}
    for dev in ("cpu", cuda):
        p = {k: (v.to(dev).requires_grad_(True) if k != "rgbnet" else
                 {n: w.to(dev).requires_grad_(True) for n, w in v.items()})
             for k, v in params.items()}
        out = dcvgo.forward(cfg, p, {"mask_cache": buffers["mask_cache"]
                                     .to(dev)},
                            *(r.to(dev) for r in rays), stepsize=0.5, bg=1.0,
                            render_depth=True)
        loss, _ = losses.encoder_losses(out, target.to(dev), train, 1024,
                                        near_thres=0.05)
        leaves = [p["density"], p["k0"], *p["rgbnet"].values()]
        grads = torch.autograd.grad(loss, leaves)
        res[str(dev)] = (out, [g.cpu() for g in grads])
    (o_cpu, g_cpu), (o_gpu, g_gpu) = res["cpu"], res[str(cuda)]
    keep = (o_cpu["raw_alpha"] != 0) != (o_gpu["raw_alpha"].cpu() != 0)
    assert float(keep.float().mean()) < 0.01
    for k in ("rgb_marched", "alphainv_last", "depth", "wsum_mid"):
        np.testing.assert_allclose(o_gpu[k].detach().cpu().numpy(),
                                   o_cpu[k].detach().numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    for g, w in zip(g_gpu, g_cpu):
        ref = float(w.abs().max())
        assert ref > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * ref)


def test_ndc_samples_and_dvqgo_forward_cuda_match_cpu(cuda):
    """The NDC samples are the same bits on the card as on the CPU (a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    which put some samples on the other side of a grid plane); then a
    DirectQVGO forward and its gradients agree between the devices."""
    from fourk_nerf_torch.models import dvqgo
    from fourk_nerf_torch.ops import render
    rng = np.random.default_rng(0)
    ro = rng.normal(0, 0.1, (64, 3)).astype(np.float32)
    ro[:, 2] = -1.0
    rd = rng.normal(0, 0.3, (64, 3)).astype(np.float32)
    rd[:, 2] = 2.0
    for K in (8, 256, 255):
        got = render.sample_ndc_pts_on_rays(torch.as_tensor(ro, device=cuda),
                                            torch.as_tensor(rd, device=cuda),
                                            K)
        want = render.sample_ndc_pts_on_rays(torch.as_tensor(ro),
                                             torch.as_tensor(rd), K)
        assert torch.equal(got.cpu(), want), K
    cfg = dvqgo.make_config(
        xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
        num_voxels=16 * 16 * 8, mpi_depth=8, rgbnet_dim=6, rgbnet_width=16,
        fast_color_thres=1.0 / 40, n_cluster=256)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        p, b = dvqgo.init(cfg, generator=torch.Generator().manual_seed(0),
                          device=dev)
        p["density"] = torch.as_tensor(rng.normal(
            -1, 2, tuple(p["density"].shape)).astype(np.float32)
            if dev.type == "cuda" else outs["density"], device=dev)
        outs.setdefault("density", p["density"].cpu().numpy())
        p["density"].requires_grad_(True)
        out = dvqgo.forward(cfg, p, b, torch.as_tensor(ro, device=dev),
                            torch.as_tensor(rd, device=dev),
                            torch.as_tensor(rd, device=dev), stepsize=1.0,
                            is_train=True)
        g, = torch.autograd.grad(out["rgb_marched"].sum(), p["density"])
        outs[dev.type] = (out["rgb_marched"].detach().cpu(), g.cpu(),
                          out["vq_state"]["embed"].cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)



#: outputs 1e-4 absolute, gradients 1e-4 of each leaf's largest entry, as
#: the DirectContractedVoxGO card test holds them
PARITY_TOL = 1e-4


def _check_parity(res):
    for k, d in res["out_diff"].items():
        assert d <= PARITY_TOL, (k, d)
    for i, d in enumerate(res["grad_rel"]):
        assert d <= PARITY_TOL, (i, d)


def test_dbvgo_background_and_forward_cuda_match_cpu(cuda):
    """DirectBiVoxGO on the card against the CPU
    (``tools/device_parity.py``). Its background samples
    ``t_max - 1 + 1 / (1 - k/K)`` divide by ``K`` as the CPU does (a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    which moved a sample near ``k = K - 1`` by 6 ulps of its magnitude,
    ~1.4): they agree within 4 ulps (4.8e-7; the norms, reduced in another
    order, move them by up to 3); then the forward of a 10^3-voxel model
    (both fields, the background on its own mask) and the gradients of its
    training loss agree within :data:`PARITY_TOL`."""
    from fourk_nerf_torch.tools import device_parity
    assert device_parity.dbvgo_bg_samples(cuda) <= 4.8e-7
    res = device_parity.compare((torch.device("cpu"), cuda),
                                *device_parity.dbvgo_case())
    _check_parity(res)
    assert float(res["outputs"]["alphainv_last_bg"].min()) < 0.99


@pytest.mark.parametrize("family", ["dmpigo", "dvgo"])
def test_tensorf_forward_and_gradients_cuda_match_cpu(cuda, family):
    """A TensoRF DirectMPIGO (NDC rays, 12x12x8) and DirectVoxGO (12^3,
    rays of the tiny scene's cameras) on the card against the CPU: the
    forward and the gradients of the training loss on every factor and the
    rgbnet within :data:`PARITY_TOL`."""
    from fourk_nerf_torch.tools import device_parity
    _check_parity(device_parity.compare(
        (torch.device("cpu"), cuda), *device_parity.tensorf_case(family)))


def test_dvgo_fine_step_cuda_matches_cpu(cuda):
    """One fine-stage step of the benchmark's chair DirectVoxGO at its own
    grid (160^3, the seeded ball scene, ``fast_color_thres`` 1e-4) on 1024
    rays through the ball, on the card and on the CPU: the forward colours
    only the weighted samples on both (``samples.k0`` equals
    ``samples.weighted``), the loss agrees within 1e-4 relative and every
    gradient within :data:`PARITY_TOL` of its leaf's largest entry."""
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.train import trainer
    from fourk_nerf_torch.utils import trace
    from portbench import inputs, program

    cfg = inputs.config("chair_syn")
    mcfg = program.model_config(cfg)
    cam, t = cfg["camera"], cfg["train"]
    params, buffers = inputs.scene(cfg, 7, torch.device("cpu"))
    rng = np.random.default_rng(7)
    ro = rng.normal(size=(1024, 3))
    ro *= 4.0311 / np.linalg.norm(ro, axis=1, keepdims=True)
    vd = rng.uniform(-0.4, 0.4, (1024, 3)) - ro
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = [torch.as_tensor(a, dtype=torch.float32)
            for a in (ro, vd, vd, rng.uniform(0, 1, (1024, 3)))]
    step = trainer.TrainStep(
        program.model_module(cfg), mcfg, ConfigDict(t),
        render_kwargs={"near": cam["near"], "far": cam["far"],
                       "bg": cam["bg"], "stepsize": cfg["model"]["stepsize"]})
    res = {}
    for dev in (torch.device("cpu"), cuda):
        p = {k: ({n: w.to(dev) for n, w in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        b = {k: v.to(dev) for k, v in buffers.items()}
        trace.reset()
        trace.enable()
        try:
            loss, _, grads = step.loss_and_grads(
                p, b, [r.to(dev) for r in rays], list(p))
            c = trace.summary()["counters"]
        finally:
            trace.disable()
            trace.reset()
        assert c["samples.k0"] == c["samples.weighted"]
        assert 0 < c["samples.k0"] < 1024 * mcfg.n_samples(
            cfg["model"]["stepsize"]) // 20
        leaves = [grads["density"], grads["k0"], *grads["rgbnet"].values()]
        res[dev.type] = (float(loss), [g.cpu() for g in leaves])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    for g, w in zip(g_gpu, g_cpu):
        ref = float(w.abs().max())
        assert ref > 0
        assert float((g - w).abs().max()) <= PARITY_TOL * ref
