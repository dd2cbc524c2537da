"""The bounded-scene encoder on the card: the fused box-sweep kernel
(``csrc/box.cu``) and its frame renderer.

:func:`sweep_box` is the kernel's wrapper. For CUDA tensors it launches the
kernel (and raises if the launch fails); for CPU tensors, and only for
them, it runs the plain version ``box_sweep.sweep_box_plain``. It counts
its launches in ``sweep_box.launches``.

:func:`block_occupancy` builds the kernel's block map of the free-space
mask, with which it skips empty space exactly (see ``csrc/box.cu``). The
map of each sweep direction and the packed rgbnet are built once per scene
and kept in the ``PackedBox`` (:func:`box_occupancy`, :func:`box_weights`).

:func:`render_frame_box_cuda` renders a full frame: rays -> the per-ray
affine of the sweep and the viewdir embedding, in the order of 16x8-pixel
tiles (``cuda_sweep.ray_order``) -> one launch -> ``[H, W]`` maps back in
row-major order. It replaces the JAX package's
``pallas_box.render_frame_box_pallas``.
A per-ray gather kernel has no window to overflow and needs no dominant
axis, so no pose is refused; a mask at another resolution than the grid is
refused, as there (``box_sweep.render_frame_box`` renders it).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common
from fourk_nerf_torch.ops import _build, box_sweep
from fourk_nerf_torch.ops.box_sweep import PackedBox
from fourk_nerf_torch.ops.cuda_sweep import pack_mlp, pack_mlp_fragments, \
    ray_order
from fourk_nerf_torch.ops.plane_sweep import mlp_layers

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 15
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])

#: the edge of the kernel's empty-space blocks, in voxels: ``kOccBlock`` of
#: ``csrc/box.cu`` (16 measured faster than 4 and 8 on the fly-through,
#: PERF.md)
OCC_BLOCK = 16


def pack_box_kernel(cfg, params: dict, buffers: dict, *,
                    use_bf16: bool) -> PackedBox:
    """The kernel's grid: ``[X*Y*Z, Cp]`` voxels in bfloat16 (``use_bf16``)
    or float32, the mask as a channel. One packing serves every pose. Raises
    ``ValueError`` for a mask at another resolution than the grid."""
    box_sweep.check_model(cfg)
    if tuple(buffers["mask_cache"].shape) != tuple(cfg.world_size):
        raise ValueError("the box kernel requires mask res == grid res")
    return box_sweep.pack_box(
        cfg, params, buffers,
        dtype=torch.bfloat16 if use_bf16 else torch.float32)


def block_occupancy(voxels, mask_ch: int, dims, strides, *,
                    block: int = OCC_BLOCK):
    """The kernel's block map: ``[ceil(Z/b), ceil(U/b), ceil(V/b)]`` uint8
    in sweep order (``dims``, ``strides`` from ``box_sweep.grid_strides``),
    1 where a ``b``-voxel block, grown by one voxel on the high side of each
    axis, holds any mask bit. A sample's nearest mask reads only the taps of
    its floor cell (``floor(z)`` clamped to ``Z-2``, ``floor(u)``,
    ``floor(v)``) and the next voxel on each axis, so a sample whose floor
    cell lies in a block marked 0 has mask 0."""
    Z, U, V = dims
    base, sz, su, sv = strides
    ar = lambda n: torch.arange(n, device=voxels.device)
    idx = (base + ar(Z)[:, None, None] * sz + ar(U)[None, :, None] * su
           + ar(V)[None, None, :] * sv)
    m = voxels[:, mask_ch][idx].float()[None, None]  # sweep order
    grown = F.max_pool3d(F.pad(m, (0, 1, 0, 1, 0, 1)), 2, stride=1)
    occ = F.max_pool3d(grown, block, stride=block, ceil_mode=True)
    return (occ[0, 0] > 0).to(torch.uint8).contiguous()


def box_occupancy(packed: PackedBox, dims, strides):
    """:func:`block_occupancy` of a packed scene at the kernel's block edge,
    built once per sweep direction and kept in ``packed.cache``."""
    key = ("occ", tuple(dims), tuple(strides))
    if key not in packed.cache:
        packed.cache[key] = block_occupancy(packed.voxels, packed.mask_ch,
                                            dims, strides)
    return packed.cache[key]


def box_weights(packed: PackedBox, mlp, cin0: int):
    """The rgbnet ``mlp`` in the kernel's layout for the grid's dtype:
    (buffer, WP, cinp, n_layers), from ``cuda_sweep.pack_mlp_fragments``
    on a bf16 grid and ``cuda_sweep.pack_mlp`` on a float32 grid. Packed
    once per scene and kept in ``packed.cache``: like the grid, the packed
    weights are for a fixed scene."""
    key = ("mlp", cin0)
    if key not in packed.cache:
        if packed.voxels.dtype == torch.bfloat16:
            packed.cache[key] = pack_mlp_fragments(mlp, cin0)
        else:
            buf, wp, n_layers = pack_mlp(mlp, cin0)
            packed.cache[key] = (buf, wp, cin0, n_layers)
    return packed.cache[key]


def sweep_box(packed: PackedBox, consts, vde, mlp, *, dims, strides,
              mask_ch: int, k0_dim: int, act_shift: float, interval: float,
              fast_thres: float, inv_nref: float, rgb_direct: bool,
              act_type: str):
    """Sweep rays through the packed scene (``pack_box_kernel``). Same
    contract as :func:`box_sweep.sweep_box_plain` on ``packed.voxels``
    with the mask as a channel: returns (rgb_feature [R,3], depth [R],
    alphainv_last [R]). The block map of this sweep direction and the
    packed ``mlp`` come from ``packed.cache`` (:func:`box_occupancy`,
    :func:`box_weights`)."""
    voxels = packed.voxels
    kw = dict(dims=dims, strides=strides, mask_ch=mask_ch, k0_dim=k0_dim,
              act_shift=act_shift, interval=interval, fast_thres=fast_thres,
              inv_nref=inv_nref, rgb_direct=rgb_direct, act_type=act_type)
    tensors = [voxels, consts, vde] + [t for wb in mlp for t in wb]
    if all(t.device.type == "cpu" for t in tensors):
        return box_sweep.sweep_box_plain(voxels, consts, vde, mlp, **kw)
    dev = consts.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("sweep_box: all tensors must be on one CUDA device "
                         "(or all on the CPU for the plain version)")
    Z, U, V = dims
    if voxels.dtype not in (torch.float32, torch.bfloat16) \
            or voxels.dim() != 2 or voxels.shape[0] != Z * U * V:
        raise ValueError("sweep_box: voxels must be [Z*U*V, Cp] "
                         "float32/bfloat16")
    Cp = voxels.shape[1]
    R = consts.shape[0]
    if vde.dim() != 2:
        raise ValueError("sweep_box: vde must be [R, E]")
    E = vde.shape[1]
    for name, t, shape in (("consts", consts, (R, 8)), ("vde", vde, (R, E))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"sweep_box: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (voxels, consts, vde)):
        raise ValueError("sweep_box: inputs must be contiguous")
    if not (0 <= mask_ch < Cp and 1 + k0_dim <= Cp and min(dims) >= 2):
        raise ValueError("sweep_box: channel layout or grid dims out of range")
    # the kernel reads the first 8 or 16 channels of a voxel
    cl = 8 if max(mask_ch, k0_dim) < 8 else 16
    if max(mask_ch, k0_dim) >= 16 or cl > Cp:
        raise ValueError("sweep_box: the kernel takes k0_dim and mask_ch < 16")
    if mask_ch != packed.mask_ch:
        raise ValueError("sweep_box: mask_ch is not the packed scene's")
    occ = box_occupancy(packed, dims, strides)
    bf16 = voxels.dtype == torch.bfloat16
    if mlp:
        cin0 = (k0_dim if rgb_direct else k0_dim - 3) + E
        if not rgb_direct and k0_dim < 3:
            raise ValueError("sweep_box: the residual form needs k0_dim >= 3")
        buf, wp, cinp, n_layers = box_weights(packed, mlp, cin0)
    else:
        if k0_dim != 3:
            raise ValueError("sweep_box: a model without rgbnet has k0_dim 3")
        cin0, cinp, wp, n_layers = 0, 16, 64, 0
        buf = torch.zeros(16, dtype=torch.uint8, device=dev)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(R, dtype=torch.float32, device=dev)
    ail = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _build.load("box")
    fn = lib.box_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    base, sz, su, sv = strides
    err = fn(voxels.data_ptr(), int(bf16), consts.data_ptr(), vde.data_ptr(),
             buf.data_ptr(), occ.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
             ail.data_ptr(), base, sz, su, sv, R, Z, U, V, Cp, mask_ch,
             k0_dim, E, common.ACT_CODES[act_type], n_layers, cin0, cinp, wp,
             cl, int(rgb_direct), float(act_shift), float(interval),
             float(fast_thres), float(inv_nref),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "box_error_string", err, "box kernel")
    sweep_box.launches += 1
    return rgb, depth, ail


sweep_box.launches = 0


def render_frame_box_cuda(cfg, params, buffers, H: int, W: int, K, c2w, *,
                          stepsize: float, near: float, bg: float,
                          inverse_y: bool = False, flip_x: bool = False,
                          flip_y: bool = False, use_bf16: bool = True,
                          device=None,
                          packed: PackedBox | None = None) -> dict:
    """Render one ``H x W`` frame of a bounded scene through one launch.

    Returns ``rgb_feature [H,W,3]``, ``rgb_marched`` (feature plus
    ``alphainv_last * bg``), ``depth [H,W]`` and ``alphainv_last [H,W]``.
    ``use_bf16`` stores the grid in bfloat16 and runs the MLP in bfloat16,
    as the JAX kernel's flag does. ``packed`` (from
    :func:`pack_box_kernel`) saves re-packing the grid for every frame of a
    fixed scene, and its dtype then sets both. A frame no ray of which hits
    the box returns the background maps without a launch."""
    box_sweep.check_model(cfg)
    dev = resolve_device(device)
    if packed is None:
        packed = pack_box_kernel(cfg, params, buffers, use_bf16=use_bf16)
    elif packed.mask_ch < 0:
        raise ValueError("the box kernel requires mask res == grid res")
    frame = box_sweep.prepare_frame_box(
        cfg, H, W, K, c2w, stepsize=stepsize, near=near, inverse_y=inverse_y,
        flip_x=flip_x, flip_y=flip_y, device=dev)
    if frame.n_hit == 0:
        return box_sweep.background(H, W, bg, dev)
    mlp = mlp_layers(params["rgbnet"]) if cfg.rgbnet_dim > 0 else []
    kw = box_sweep.sweep_kwargs(cfg, frame, packed, stepsize)
    order, inverse = ray_order(H, W, dev)
    rgb, depth, ail = sweep_box(packed, frame.consts[order],
                                frame.vde[order].contiguous(), mlp, **kw)
    return box_sweep.assemble(rgb[inverse], depth[inverse], ail[inverse], H,
                              W, bg)
