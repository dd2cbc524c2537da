"""The bounded-scene encoder on the card: the fused box-sweep kernel
(``csrc/box.cu``) and its frame renderer.

:func:`sweep_box` is the kernel's wrapper. For CUDA tensors it launches the
kernel (and raises if the launch fails); for CPU tensors, and only for
them, it runs the plain version ``box_sweep.sweep_box_plain``. It counts
its launches in ``sweep_box.launches``.

:func:`render_frame_box_cuda` renders a full frame: rays -> the per-ray
affine of the sweep and the viewdir embedding -> one launch -> ``[H, W]``
maps. It replaces the JAX package's ``pallas_box.render_frame_box_pallas``.
A per-ray gather kernel has no window to overflow and needs no dominant
axis, so no pose is refused; a mask at another resolution than the grid is
refused, as there (``box_sweep.render_frame_box`` renders it).
"""

from __future__ import annotations

import ctypes

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common
from fourk_nerf_torch.ops import _build, box_sweep
from fourk_nerf_torch.ops.box_sweep import PackedBox
from fourk_nerf_torch.ops.cuda_sweep import pack_mlp
from fourk_nerf_torch.ops.plane_sweep import mlp_layers

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 14
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])


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


def sweep_box(voxels, consts, vde, mlp, *, dims, strides, mask_ch: int,
              k0_dim: int, act_shift: float, interval: float,
              fast_thres: float, inv_nref: float, rgb_direct: bool,
              act_type: str):
    """Sweep rays through the packed voxels. Same contract as
    :func:`box_sweep.sweep_box_plain` with the mask as a channel: returns
    (rgb_feature [R,3], depth [R], alphainv_last [R])."""
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
    bf16 = voxels.dtype == torch.bfloat16
    if mlp:
        cin0 = (k0_dim if rgb_direct else k0_dim - 3) + E
        flat, wp, n_layers = pack_mlp(mlp, cin0, bf16=bf16)
    else:
        if k0_dim != 3:
            raise ValueError("sweep_box: a model without rgbnet has k0_dim 3")
        cin0, wp, n_layers = 0, 64, 0
        flat = torch.zeros(4, dtype=torch.float32, device=dev)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(R, dtype=torch.float32, device=dev)
    ail = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _build.load("box")
    fn = lib.box_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    base, sz, su, sv = strides
    err = fn(voxels.data_ptr(), int(bf16), consts.data_ptr(), vde.data_ptr(),
             flat.data_ptr(), rgb.data_ptr(), depth.data_ptr(), ail.data_ptr(),
             base, sz, su, sv, R, Z, U, V, Cp, mask_ch, k0_dim, E,
             common.ACT_CODES[act_type], n_layers, cin0, wp,
             flat.numel() if n_layers else 0, int(rgb_direct),
             float(act_shift), float(interval), float(fast_thres),
             float(inv_nref), torch.cuda.current_stream(dev).cuda_stream)
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
    rgb, depth, ail = sweep_box(
        packed.voxels, frame.consts, frame.vde, mlp,
        **box_sweep.sweep_kwargs(cfg, frame, packed, stepsize))
    return box_sweep.assemble(rgb, depth, ail, H, W, bg)
