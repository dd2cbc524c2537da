"""The box kernel's empty-space skipping and frame driver, on the CPU.

The kernel (csrc/box.cu) skips a sample whose floor cell lies in a block
that ``cuda_box.block_occupancy`` marks empty. These tests hold the map
to that rule against the plain version: every sample that
``box_sweep.sweep_box_plain`` finds unmasked lies in a marked block, on
random masks, grids that the block edge does not divide, and every sweep
axis and sign. They also hold the frame driver's tiled ray order (on the
CPU it runs the plain version) to the row-major plain render, exactly, and
the tensor-core MLP's weight packing at the box's geometry."""

import numpy as np
import pytest
import torch

import chip_smoke
from fourk_nerf_torch.models import common as tcommon, dvgo as tdvgo
from fourk_nerf_torch.ops import box_sweep, cuda_box, cuda_sweep

AXES = [(a, f) for a in range(3) for f in (False, True)]


def _packed_grid(world, rng, fill):
    """``[X*Y*Z, 8]`` float32 voxels: density 0 (alpha tiny and non-zero
    at act_shift -10), k0 N(0, 1) in channels 1..3, a sparse 0/1 mask at
    channel 4 (single voxels and a few 2x2x2 clusters)."""
    X, Y, Z = world
    mask = rng.uniform(size=world) < fill
    for _ in range(2):
        x, y, z = (int(rng.integers(0, n - 1)) for n in world)
        mask[x:x + 2, y:y + 2, z:z + 2] = True
    vox = np.zeros((X, Y, Z, 8), np.float32)
    vox[..., 1:4] = rng.normal(size=(X, Y, Z, 3))
    vox[..., 4] = mask
    return torch.as_tensor(vox.reshape(-1, 8))


def _rays(dims, rng, n=600):
    """Rays through and around the sweep-ordered box ``dims``: starts
    uniform in [-1, dim], steps of up to 0.7 voxel a sample along each
    axis (some exactly along a face), 60 samples."""
    Z, U, V = dims
    c = np.zeros((n, 8), np.float32)
    for col, d in ((0, U), (2, V), (4, Z)):
        c[:, col] = rng.uniform(-1.0, d, n)
        c[:, col + 1] = rng.uniform(-0.7, 0.7, n)
    c[:, 1][:40] = 0.0                       # u fixed
    c[:, 0][:20] = np.floor(c[:, 0][:20])    # on a voxel face
    c[:, 5] = np.where(np.abs(c[:, 5]) < 1e-8, 1e-8, c[:, 5])
    c[:, 6] = 59.0
    return torch.as_tensor(c)


def _unmasked_and_blocks(vox, consts, dims, strides, occ, block):
    """Per sample (every k <= kmax): in range and unmasked, as the plain
    version decides it (float32 grid, its arithmetic), and whether the
    floor cell's block is marked in ``occ``."""
    Z, U, V = dims
    base, sz, su, sv = strides
    u0, du, v0, dv, z0, dz, kmax = consts[:, :7].unbind(1)
    unmasked, marked = [], []
    for k in range(int(kmax.max()) + 1):
        kf = float(k)
        u, v, z = u0 + du * kf, v0 + dv * kf, z0 + dz * kf
        valid = ((u >= 0) & (u <= U - 1) & (v >= 0) & (v <= V - 1)
                 & (z >= 0) & (z <= Z - 1))
        jf = torch.floor(z).clamp(0, Z - 2)
        uf = torch.floor(u).clamp(0, U - 1)
        vf = torch.floor(v).clamp(0, V - 1)
        fz, fu, fv = z - jf, u - uf, v - vf
        wv0 = 1.0 - fv
        wv1 = 1.0 - wv0
        wu0 = 1.0 - fu
        wu1 = 1.0 - wu0
        j, iu0, iv0 = jf.long(), uf.long(), vf.long()
        iu1 = torch.clamp_max(iu0 + 1, U - 1)
        iv1 = torch.clamp_max(iv0 + 1, V - 1)
        pz = base + torch.where(fz < 0.5, j, j + 1) * sz
        m = vox[:, 4]

        def row(qv):
            return wu0 * m[pz + iu0 * su + qv] + wu1 * m[pz + iu1 * su + qv]

        ms = (torch.floor(wv0 + 0.5) * row(iv0 * sv)
              + torch.floor(wv1 + 0.5) * row(iv1 * sv))
        unmasked.append(valid & (torch.floor(ms + 0.5) > 0.5))
        marked.append(occ[j // block, iu0 // block, iv0 // block].bool())
    return torch.stack(unmasked), torch.stack(marked)


@pytest.mark.parametrize("axis,flip", AXES)
@pytest.mark.parametrize("world,block,fill", [
    ((11, 13, 9), 4, 0.01),    # no extent a multiple of the block
    ((16, 12, 20), 8, 0.003),  # 12 and 20 not multiples of 8
    ((5, 7, 6), 2, 0.01),      # 5 and 7 odd at the smallest block
    ((40, 35, 50), 16, 1e-4),  # the shipped block edge, none divides
])
def test_block_occupancy_is_conservative(axis, flip, world, block, fill):
    rng = np.random.default_rng(sum(world) + 7 * axis + int(flip))
    vox = _packed_grid(world, rng, fill)
    dims, strides = box_sweep.grid_strides(world, axis, flip)
    occ = cuda_box.block_occupancy(vox, 4, dims, strides, block=block)
    assert occ.dtype == torch.uint8
    assert tuple(occ.shape) == tuple(-(-d // block) for d in dims)
    consts = _rays(dims, rng)
    vde = torch.zeros((consts.shape[0], 0))
    stats: dict = {}
    box_sweep.sweep_box_plain(
        vox, consts, vde, [], dims=dims, strides=strides, mask_ch=4,
        k0_dim=3, act_shift=-10.0, interval=0.5, fast_thres=0.0,
        inv_nref=0.01, rgb_direct=False, act_type="relu", early_exit=False,
        stats=stats)
    unmasked, marked = _unmasked_and_blocks(vox, consts, dims, strides, occ,
                                            block)
    # the plain version weights every unmasked sample in range here
    assert int(unmasked.sum()) == stats["mlp_samples"] > 0
    assert int((unmasked & ~marked).sum()) == 0
    n_in, n_occ = chip_smoke.occupied_samples(consts, occ, dims, block)
    assert n_in == stats["samples"]
    assert stats["mlp_samples"] <= n_occ < n_in  # some samples are skipped


def test_box_occupancy_is_kept_per_direction():
    rng = np.random.default_rng(0)
    world = (9, 10, 11)
    packed = box_sweep.PackedBox(_packed_grid(world, rng, 0.02), 4, None)
    for axis, flip in AXES:
        dims, strides = box_sweep.grid_strides(world, axis, flip)
        occ = cuda_box.box_occupancy(packed, dims, strides)
        assert cuda_box.box_occupancy(packed, dims, strides) is occ
        assert torch.equal(occ, cuda_box.block_occupancy(
            packed.voxels, 4, dims, strides))
    assert len(packed.cache) == len(AXES)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_box_weights_are_packed_once_per_scene(dtype):
    """The rgbnet in the kernel's layout for the grid's dtype (fragments on
    bf16, the float layout on float32), packed on the first call and then
    taken from the scene's cache."""
    rng = np.random.default_rng(2)
    dims = [39, 64, 64, 3]
    mlp = [(torch.as_tensor(rng.normal(size=dims[i:i + 2]),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=dims[i + 1]),
                            dtype=torch.float32)) for i in range(3)]
    packed = box_sweep.PackedBox(torch.zeros((8, 8), dtype=dtype), 4, None)
    got = cuda_box.box_weights(packed, mlp, 39)
    assert cuda_box.box_weights(packed, mlp, 39) is got
    if dtype == torch.bfloat16:
        want = cuda_sweep.pack_mlp_fragments(mlp, 39)
    else:
        buf, wp, n = cuda_sweep.pack_mlp(mlp, 39)
        want = (buf, wp, 39, n)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    assert len(packed.cache) == 1


def _scene(rgbnet_dim, direct):
    cfg = tdvgo.make_config(
        xyz_min=[-1.0, -0.8, -0.6], xyz_max=[1.0, 0.9, 0.7],
        num_voxels=14 * 12 * 10, num_voxels_base=14 * 12 * 10,
        alpha_init=1e-2, rgbnet_dim=rgbnet_dim, rgbnet_direct=direct,
        rgbnet_width=16, rgbnet_depth=3, viewbase_pe=2,
        fast_color_thres=1e-4)
    params, buffers = tdvgo.init(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    params["density"] = torch.as_tensor(
        rng.normal(0, 2, params["density"].shape).astype(np.float32))
    params["k0"] = torch.as_tensor(
        rng.normal(0, 1, params["k0"].shape).astype(np.float32))
    buffers["mask_cache"] = torch.as_tensor(
        rng.uniform(size=cfg.world_size) > 0.4)
    return cfg, params, buffers


def _look_at(h, w, ax, ay, dist=2.8):
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    R = (Ry @ Rx).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:3, :3] = R
    c2w[:3, 3] = R @ np.array([0, 0, dist], np.float32)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    return K, c2w


@pytest.mark.parametrize("rgbnet_dim,direct,use_bf16,angle", [
    (6, False, True, (0.4, 0.3)),
    (6, True, False, (0.0, np.pi)),
    (0, False, True, (-0.5 * np.pi, 0.2)),
])
def test_render_frame_box_cuda_tiled_equals_plain(rgbnet_dim, direct,
                                                  use_bf16, angle):
    """13x21 rays (no multiple of the 16x8 tile) in the driver's tile
    order give the row-major plain render bit for bit, but for the colour
    of the float32 MLP: a float32 matmul over another batch of rows may
    sum in another order, so it agrees to 1e-7 there (1.9e-9 measured)."""
    cfg, params, buffers = _scene(rgbnet_dim, direct)
    h, w = 13, 21
    K, c2w = _look_at(h, w, *angle)
    kw = dict(stepsize=0.5, near=0.2, bg=0.7, use_bf16=use_bf16,
              device="cpu")
    n0 = cuda_box.sweep_box.launches
    got = cuda_box.render_frame_box_cuda(cfg, params, buffers, h, w, K, c2w,
                                         **kw)
    assert cuda_box.sweep_box.launches == n0  # CPU: the plain version
    ref = box_sweep.render_frame_box(cfg, params, buffers, h, w, K, c2w, **kw)
    assert float((ref["rgb_marched"] - 0.7).abs().max()) > 0.05
    for k in ("rgb_marched", "rgb_feature", "depth", "alphainv_last"):
        if use_bf16 or not rgbnet_dim or not k.startswith("rgb"):
            assert torch.equal(got[k], ref[k]), k
        else:
            assert float((got[k] - ref[k]).abs().max()) <= 1e-7, k


@pytest.mark.parametrize("cin0", [39, 36])
@pytest.mark.parametrize("width", [128, 100])
def test_pack_mlp_fragments_box_geometry(cin0, width):
    """The box's rgbnet (cin0 39 direct, 36 residual; 128-wide kernel):
    the fragments unpack to pack_mlp(..., bf16=True)'s weights, zero
    padded to cinp 48 and WP 128; the MLP through either gives the same
    logits; packing the unpacked weights gives the same bytes."""
    rng = np.random.default_rng(cin0 + width)
    dims = [cin0, width, width, 3]
    mlp = [(torch.as_tensor(rng.normal(size=(dims[i], dims[i + 1])) * 0.2,
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(size=dims[i + 1]) * 0.1,
                            dtype=torch.float32)) for i in range(3)]
    buf, wp, cinp, n = cuda_sweep.pack_mlp_fragments(mlp, cin0)
    assert (wp, cinp, n) == (128, 48, 3)
    assert buf.dtype == torch.uint8 and buf.numel() % 16 == 0
    frag = cuda_sweep.unpack_mlp_fragments(buf, cinp, wp, n)
    flat, _, _ = cuda_sweep.pack_mlp(mlp, cin0, bf16=True)
    o = 0
    for li, (w, b) in enumerate(frag):
        rows, cols = (cin0 if li == 0 else wp), (4 if li == n - 1 else wp)
        wr = flat[o:o + rows * cols].reshape(rows, cols)
        br = flat[o + rows * cols:o + rows * cols + cols]
        o += rows * cols + cols
        m = min(cols, w.shape[1])
        assert torch.equal(w[:rows, :m], wr[:, :m])
        assert not w[rows:].any() and not w[:, m:].any() and not wr[:, m:].any()
        assert torch.equal(b[:min(m, b.numel())], br[:min(m, b.numel())])
    x = torch.as_tensor(rng.normal(size=(5, cin0)), dtype=torch.float32)
    act = tcommon.activation("relu")
    hf = torch.cat([x, torch.zeros(5, cinp - cin0)], 1)
    hr = x
    for li, ((w, b), (wl, bl)) in enumerate(zip(frag, mlp)):
        hf = hf @ w[:, :b.numel()] + b
        hr = hr @ box_sweep.round_bf16(wl) + bl
        if li < n - 1:
            hf, hr = act(hf), act(hr)
    assert torch.allclose(hf[:, :3], hr, rtol=0, atol=1e-5)
    again = [(w[:mlp[i][0].shape[0], :mlp[i][0].shape[1]],
              b[:mlp[i][1].shape[0]]) for i, (w, b) in enumerate(frag)]
    assert torch.equal(cuda_sweep.pack_mlp_fragments(again, cin0)[0], buf)
