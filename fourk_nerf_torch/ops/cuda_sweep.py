"""The encoder of the 4K frame on the card: the fused plane-sweep kernel
(``csrc/sweep.cu``) and its frame driver.

:func:`sweep` is the kernel's wrapper. For CUDA tensors it launches the
kernel (and raises if the launch fails); for CPU tensors, and only for
them, it runs the plain version ``plane_sweep.sweep_plain``. It counts its
launches in ``sweep.launches``.

:func:`render_frame_cuda` renders a full frame: rays -> per-ray affine
coefficients and viewdir embedding, in the order of 16x8-pixel tiles
(:func:`ray_order`) -> one sweep launch -> ``[H, W]`` maps.
It replaces the JAX package's ``pallas_sweep.render_frame_pallas``; unlike
that driver it has no footprint window to overflow (a gather kernel reads
any tap), so there is no patch check.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common, dmpigo
from fourk_nerf_torch.ops import _build, cuda_sr, plane_sweep
from fourk_nerf_torch.ops.plane_sweep import PackedGrid

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 17 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def pack_grids_kernel(params: dict, buffers: dict, *,
                      use_bf16: bool) -> PackedGrid:
    """The kernel's grid: ``[Z, X, Y, Cp]`` in bfloat16 (``use_bf16``) or
    float32, a mask at another resolution nearest-resampled onto the grid.
    Cp is a multiple of 8, so a bf16 voxel is one or more 16-byte rows."""
    return plane_sweep.pack_grids(
        params, buffers,
        dtype=torch.bfloat16 if use_bf16 else torch.float32)


def _mlp_width(mlp, cin0: int) -> tuple[int, int]:
    """(n_layers, padded width WP) of an rgbnet the kernel takes."""
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
    return n, 64 if width <= 64 else 128


def _pad(t, rows: int, cols: int):
    out = torch.zeros((rows, cols), dtype=torch.float32, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def pack_mlp(mlp, cin0: int, *, bf16: bool = False):
    """[(w [Cin, W], b [W]), ...] -> (flat float32 buffer, padded width WP,
    n_layers) in the layout of ``csrc/sweep_common.cuh`` (the float32 path
    of this kernel and the box kernel): W0 [cin0][WP], b0 [WP], hidden
    W [WP][WP], b [WP], output W [WP][4], b [4]. Zero padding is exact: a
    padded unit's outgoing weights are zero. ``bf16`` rounds the weights
    (not the biases) to bfloat16 values, the MLP type of a bf16 grid."""
    n, wp = _mlp_width(mlp, cin0)
    parts = []
    for li, (w, b) in enumerate(mlp):
        rows = cin0 if li == 0 else wp
        cols = 4 if li == n - 1 else wp
        w = plane_sweep.round_bf16(w.float()) if bf16 else w.float()
        parts += [_pad(w, rows, cols).reshape(-1),
                  _pad(b.float()[None], 1, cols).reshape(-1)]
    return torch.cat(parts).contiguous(), wp, n


def pack_mlp_fragments(mlp, cin0: int):
    """The bf16 path's weights for the tensor-core MLP of
    ``csrc/sweep_queue.cuh``: one byte buffer (uint8, a whole number of
    16-byte words) holding each layer's bf16-rounded weights ``[K, N]`` in
    ``mma.sync`` m16n8k16 fragment order (the order of
    ``cuda_sr._to_fragments``; K is cin0 padded to 16 for layer 0 and WP
    after it, N is WP for layers before the output and 16 for the output,
    of which 3 are used), then the float32 biases b0 [WP], each hidden
    [WP], output [8]. Returns (buffer, WP, cinp, n_layers). Zero padding is
    exact, as in :func:`pack_mlp`."""
    n, wp = _mlp_width(mlp, cin0)
    cinp = -(-cin0 // 16) * 16
    frags, biases = [], []
    for li, (w, b) in enumerate(mlp):
        rows = cinp if li == 0 else wp
        cols = 16 if li == n - 1 else wp
        w = plane_sweep.round_bf16(w.float())
        frags.append(cuda_sr._to_fragments(_pad(w, rows, cols)))
        biases.append(_pad(b.float()[None], 1, 8 if li == n - 1 else wp)
                      .reshape(-1))
    buf = torch.cat([torch.cat(frags).to(torch.bfloat16).view(torch.uint8),
                     torch.cat(biases).view(torch.uint8)])
    return buf.contiguous(), wp, cinp, n


def unpack_mlp_fragments(buf, cinp: int, wp: int, n_layers: int):
    """The inverse of :func:`pack_mlp_fragments`: [(w [K, N] float32 of
    bf16 values, b float32), ...] at the padded sizes."""
    shapes = [(cinp, wp)] + [(wp, wp)] * (n_layers - 2) + [(wp, 16)]
    nw = sum(k * n for k, n in shapes)
    fr = buf[:2 * nw].view(torch.bfloat16).float()
    bi = buf[2 * nw:2 * nw + 4 * ((n_layers - 1) * wp + 8)].view(torch.float32)
    out, o, ob = [], 0, 0
    for li, (k, n) in enumerate(shapes):
        w = fr[o:o + k * n].reshape(k // 16, n // 16, 8, 4, 2, 2, 2) \
            .permute(cuda_sr._UNFRAG).reshape(k, n)
        nb = 8 if li == n_layers - 1 else wp
        out.append((w, bi[ob:ob + nb]))
        o += k * n
        ob += nb
    return out


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
    # the kernel reads the first 8 or 16 channels of a voxel
    cl = 8 if max(mask_ch, k0_dim) < 8 else 16
    if max(mask_ch, k0_dim) >= 16 or cl > Cp:
        raise ValueError("sweep: the kernel takes k0_dim and mask_ch < 16")
    cin0 = k0_dim + 3 * (1 + 2 * spatial_pe) + E
    bf16 = packed.dtype == torch.bfloat16
    if bf16:
        buf, wp, cinp, n_layers = pack_mlp_fragments(mlp, cin0)
    else:
        buf, wp, n_layers = pack_mlp(mlp, cin0)
        cinp = cin0
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(R, dtype=torch.float32, device=dev)
    ail = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _build.load("sweep")
    fn = lib.sweep_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(packed.data_ptr(), int(bf16), act_shift.data_ptr(), a.data_ptr(),
             b.data_ptr(), vde.data_ptr(), buf.data_ptr(), rgb.data_ptr(),
             depth.data_ptr(), ail.data_ptr(), R, Z, X, Y, Cp, Xl, Yl,
             mask_ch, k0_dim, E, spatial_pe, common.ACT_CODES[act_type],
             n_layers, cin0, cinp, wp, cl, float(interval), float(fast_thres),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "sweep_error_string", err, "sweep kernel")
    sweep.launches += 1
    return rgb, depth, ail


sweep.launches = 0


# the pixel tile one thread block of the kernel takes: 4 warps of 16 x 2
TILE_W, TILE_H = 16, 8


@functools.lru_cache(maxsize=8)
def ray_order(H: int, W: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse) of the rays of an ``H x W`` frame as the frame
    driver hands them to the kernel: ``TILE_W x TILE_H`` pixel tiles in
    row-major order over the frame, each tile row by row, so that every
    block of 128 rays is one tile and every warp 16 x 2 neighbouring pixels,
    whose taps share cache lines (tiles at the edges of a frame that the
    tile does not divide hold fewer pixels). ``order`` lists row-major pixel
    indices; ``inverse`` maps kernel order back."""
    y = torch.arange(H, device=device).repeat_interleave(W)
    x = torch.arange(W, device=device).repeat(H)
    key = (((y // TILE_H) * -(-W // TILE_W) + x // TILE_W) * (TILE_W * TILE_H)
           + (y % TILE_H) * TILE_W + x % TILE_W)
    order = torch.argsort(key)
    return order, torch.argsort(order)


def prepare_frame(cfg, H: int, W: int, K, c2w, *, device,
                  inverse_y: bool = False, flip_x: bool = False,
                  flip_y: bool = False):
    """The kernel's per-ray inputs of one camera, ``a, b [H*W, 2]`` and
    ``vde [H*W, E]`` (``plane_sweep.prepare_frame``) in :func:`ray_order`,
    and the inverse order that brings the kernel's outputs back to
    row-major pixels."""
    a, b, vde = plane_sweep.prepare_frame(
        cfg, H, W, K, c2w, device=device, inverse_y=inverse_y, flip_x=flip_x,
        flip_y=flip_y)
    order, inverse = ray_order(H, W, a.device)
    return a[order], b[order], vde[order].contiguous(), inverse


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
    a, b, vde, inverse = prepare_frame(
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
    return plane_sweep.assemble(rgb[inverse], depth[inverse], ail[inverse],
                                H, W, bg)
