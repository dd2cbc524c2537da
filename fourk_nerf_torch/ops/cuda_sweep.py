"""The encoder of the 4K frame on the card: the fused plane-sweep kernel
(``csrc/sweep.cu``) and its frame driver.

:func:`sweep` is the kernel's wrapper. For CUDA tensors it launches the
kernel (and raises if the launch fails); for CPU tensors, and only for
them, it runs the plain version ``plane_sweep.sweep_plain``. It counts its
launches in ``sweep.launches``.

:func:`render_frame_cuda` renders a full frame: rays -> per-ray affine
coefficients and viewdir embedding -> one sweep launch -> ``[H, W]`` maps.
It replaces the JAX package's ``pallas_sweep.render_frame_pallas``; unlike
that driver it has no footprint window to overflow (a gather kernel reads
any tap), so there is no patch check.
"""

from __future__ import annotations

import ctypes

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common, dmpigo
from fourk_nerf_torch.ops import _build, plane_sweep
from fourk_nerf_torch.ops.plane_sweep import PackedGrid

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 16 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def pack_grids_kernel(params: dict, buffers: dict, *,
                      use_bf16: bool) -> PackedGrid:
    """The kernel's grid: ``[Z, X, Y, Cp]`` in bfloat16 (``use_bf16``) or
    float32, a mask at another resolution nearest-resampled onto the grid.
    Cp is a multiple of 8, so a bf16 voxel is one or more 16-byte rows."""
    return plane_sweep.pack_grids(
        params, buffers,
        dtype=torch.bfloat16 if use_bf16 else torch.float32)


def pack_mlp(mlp, cin0: int, *, bf16: bool = False):
    """[(w [Cin, W], b [W]), ...] -> (flat float32 buffer, padded width WP,
    n_layers) in the kernel's shared-memory layout: W0 [cin0][WP], b0 [WP],
    hidden W [WP][WP], b [WP], output W [WP][4], b [4]. Zero padding is
    exact: a padded unit's outgoing weights are zero. ``bf16`` rounds the
    weights (not the biases) to bfloat16 values, the MLP type of a bf16
    grid."""
    n = len(mlp)
    if n < 2:
        raise ValueError("the sweep kernel needs an rgbnet of depth >= 2")
    width = mlp[0][0].shape[1]
    if mlp[0][0].shape[0] != cin0:
        raise ValueError(f"rgbnet input width {mlp[0][0].shape[0]} != {cin0}")
    if width > 128 or any(w.shape != (width, width) for w, _ in mlp[1:-1]) \
            or mlp[-1][0].shape != (width, 3):
        raise ValueError("the sweep kernel takes hidden widths <= 128, all "
                         "equal, and 3 outputs")
    wp = 64 if width <= 64 else 128
    dev = mlp[0][0].device

    def pad(t, rows, cols):
        out = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
        out[:t.shape[0], :t.shape[1]] = t
        return out.reshape(-1)

    parts = []
    for li, (w, b) in enumerate(mlp):
        rows = cin0 if li == 0 else wp
        cols = 4 if li == n - 1 else wp
        w = plane_sweep.round_bf16(w.float()) if bf16 else w.float()
        parts += [pad(w, rows, cols), pad(b.float()[None], 1, cols)]
    return torch.cat(parts).contiguous(), wp, n


def sweep(packed, act_shift, a, b, vde, mlp, *, Xl: int, Yl: int,
          mask_ch: int, k0_dim: int, interval: float, fast_thres: float,
          spatial_pe: int, act_type: str):
    """Sweep rays through the packed grid. Same contract as
    :func:`plane_sweep.sweep_plain`: returns (rgb_feature [R,3],
    depth [R], alphainv_last [R])."""
    kw = dict(Xl=Xl, Yl=Yl, mask_ch=mask_ch, k0_dim=k0_dim,
              interval=interval, fast_thres=fast_thres,
              spatial_pe=spatial_pe, act_type=act_type)
    tensors = [packed, act_shift, a, b, vde] + [t for wb in mlp for t in wb]
    if all(t.device.type == "cpu" for t in tensors):
        return plane_sweep.sweep_plain(packed, act_shift, a, b, vde, mlp, **kw)
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("sweep: all tensors must be on one CUDA device "
                         "(or all on the CPU for the plain version)")
    if packed.dtype not in (torch.float32, torch.bfloat16) or packed.dim() != 4:
        raise ValueError("sweep: packed must be [Z,X,Y,Cp] float32/bfloat16")
    Z, X, Y, Cp = packed.shape
    R = a.shape[0]
    E = vde.shape[1] if vde.dim() == 2 else -1
    for name, t, shape in (("act_shift", act_shift, (Z,)), ("a", a, (R, 2)),
                           ("b", b, (R, 2)), ("vde", vde, (R, E))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"sweep: {name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (packed, act_shift, a, b, vde)):
        raise ValueError("sweep: inputs must be contiguous")
    if not (0 <= mask_ch < Cp and 1 + k0_dim <= Cp and Xl <= X and Yl <= Y):
        raise ValueError("sweep: channel layout or logical dims out of range")
    cin0 = k0_dim + 3 * (1 + 2 * spatial_pe) + E
    flat, wp, n_layers = pack_mlp(mlp, cin0,
                                  bf16=packed.dtype == torch.bfloat16)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(R, dtype=torch.float32, device=dev)
    ail = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _build.load("sweep")
    fn = lib.sweep_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(packed.data_ptr(), int(packed.dtype == torch.bfloat16),
             act_shift.data_ptr(), a.data_ptr(), b.data_ptr(), vde.data_ptr(),
             flat.data_ptr(), rgb.data_ptr(), depth.data_ptr(), ail.data_ptr(),
             R, Z, X, Y, Cp, Xl, Yl, mask_ch, k0_dim, E, spatial_pe,
             common.ACT_CODES[act_type], n_layers, cin0, wp, flat.numel(),
             float(interval), float(fast_thres),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "sweep_error_string", err, "sweep kernel")
    sweep.launches += 1
    return rgb, depth, ail


sweep.launches = 0


def render_frame_cuda(cfg, params, buffers, H: int, W: int, K, c2w, *,
                      stepsize: float, bg: float, use_bf16: bool = True,
                      device=None, packed: PackedGrid | None = None,
                      inverse_y: bool = False, flip_x: bool = False,
                      flip_y: bool = False) -> dict:
    """Render one ``H x W`` frame through one sweep launch.

    Returns ``rgb_feature [H,W,3]``, ``rgb_marched`` (feature plus
    ``alphainv_last * bg``), ``depth [H,W]`` and ``alphainv_last [H,W]``.
    ``use_bf16`` stores the grid in bfloat16 and runs the MLP in bfloat16,
    as the JAX kernel's flag does. ``packed`` (from
    :func:`pack_grids_kernel`) saves re-packing the grid for every frame of
    a fixed scene, and its dtype then sets both."""
    if not dmpigo.plane_aligned_ok(cfg, stepsize, ndc=True):
        raise ValueError("the sweep needs the plane-aligned NDC setup "
                         "(dmpigo.plane_aligned_ok)")
    dev = resolve_device(device)
    if packed is None:
        packed = pack_grids_kernel(params, buffers, use_bf16=use_bf16)
    a, b, vde = plane_sweep.prepare_frame(
        cfg, H, W, K, c2w, device=dev, inverse_y=inverse_y, flip_x=flip_x,
        flip_y=flip_y)
    X, Y, _ = cfg.world_size
    rgb, depth, ail = sweep(
        packed.packed, packed.act_shift, a, b, vde,
        plane_sweep.mlp_layers(params["rgbnet"]), Xl=X, Yl=Y,
        mask_ch=packed.mask_ch, k0_dim=cfg.k0_dim,
        interval=float(stepsize * cfg.voxel_size_ratio),
        fast_thres=float(cfg.fast_color_thres), spatial_pe=cfg.spatial_pe,
        act_type=cfg.act_type)
    return plane_sweep.assemble(rgb, depth, ail, H, W, bg)
