"""Bounded-scene sweep, eval form: the plain PyTorch version of the box
kernel.

A DirectVoxGO ray enters the scene box at ``t_min`` and takes samples
``k = 0..kmax`` one ``stepdist`` apart along its unit direction, so its
position in grid coordinates is affine in k: ``pos(k) = aff0 + dk * k``.
The frame's sweep axis ``z`` is the grid axis along which its rays advance
fastest (flipped when they run against it); ``u`` and ``v`` are the two
axes after it in cyclic order. The sweep takes the samples of every ray in
order and, per sample, a trilinear sample of the packed
``[density | k0 | mask]`` voxels (blend along u, then v, then the two z
planes), an exact nearest-neighbour free-space mask, softplus raw2alpha
with the model's scalar ``act_shift``, ``fast_color_thres`` on alpha and
again on the weight, the rgbnet MLP on ``[k0 | viewdir PE]`` (three colour
modes) for the samples with a non-zero weight, and the front-to-back
composite with early termination.

Same semantics as the JAX package's ``pallas_box._box_kernel``: a sample
counts while its affine grid position is in range
(``0 <= u <= U-1`` and so on), not its world point as in the XLA slab
sweep, so the two differ only at knife-edge samples on the box faces. The
TPU form's slabs, windows and hat-weight matmuls (which exist to avoid
gathers) are replaced by plain gathers, and no pose is refused for lack of
a dominant axis. With a bfloat16 grid the sweep rounds where the Pallas
kernel does under ``use_bf16``: the two u hat weights and the MLP's
inputs, weights and hidden activations.

:func:`sweep_box_plain` is what ``ops.cuda_box.sweep_box`` runs for CPU
tensors and what the kernel is held against on the card. A mask at another
resolution than the grid is looked up at its own resolution here (the
kernel's frame renderer refuses it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourk_nerf_torch.device import as_tensor, resolve_device
from fourk_nerf_torch.models import common
from fourk_nerf_torch.ops import rays as ray_ops, render
from fourk_nerf_torch.ops.plane_sweep import assemble, mlp_layers, \
    round_bf16


@dataclasses.dataclass(frozen=True)
class PackedBox:
    """``voxels [X*Y*Z, Cp]``: channel 0 density, ``1..k0_dim`` k0, then
    the 0/1 mask at ``mask_ch`` (``-1`` when the mask has another
    resolution and rides in ``mask [mX,mY,mZ]`` instead), zero padding to
    a multiple of 8 channels. ``cache`` keeps the box kernel's inputs that
    are fixed for a scene: its block maps of the mask, one per sweep
    direction, and its packed rgbnet (``cuda_box``)."""

    voxels: torch.Tensor
    mask_ch: int
    mask: torch.Tensor | None
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)


@dataclasses.dataclass(frozen=True)
class BoxFrame:
    """One camera's sweep inputs, row-major over pixels: ``consts [R, 8]``
    (u0, du, v0, dv, z0, dz, kmax, 0), ``vde [R, E]``, the sweep ``axis``
    and its ``flip``, and the number of rays that hit the box."""

    consts: torch.Tensor
    vde: torch.Tensor
    axis: int
    flip: bool
    n_hit: int


def perm(axis: int):
    """(z, u, v) grid axes of a sweep along ``axis``."""
    return (axis, (axis + 1) % 3, (axis + 2) % 3)


def check_model(cfg):
    if cfg.density_type != "DenseGrid" or cfg.k0_type != "DenseGrid":
        raise ValueError("the box sweep requires dense grids")
    if cfg.rgbnet_full_implicit:
        raise ValueError("the box sweep: rgbnet_full_implicit unsupported")


def pack_box(cfg, params: dict, buffers: dict, *,
             dtype=torch.float32) -> PackedBox:
    """Pack the model's grids for the sweep, in their own ``[X,Y,Z]``
    order: the sweep axis of a frame is a matter of strides."""
    density, k0 = params["density"], params["k0"]
    X, Y, Z, C = k0.shape
    mask = buffers["mask_cache"]
    channel = tuple(mask.shape) == (X, Y, Z)
    cp = 1 + C + int(channel)
    Cp = cp + (-cp) % 8
    vox = torch.zeros((X, Y, Z, Cp), dtype=dtype, device=density.device)
    vox[..., 0:1] = density
    vox[..., 1:1 + C] = k0
    if channel:
        vox[..., 1 + C] = mask
    return PackedBox(vox.reshape(-1, Cp), 1 + C if channel else -1,
                     None if channel else mask)


def grid_strides(world_size, axis: int, flip: bool):
    """(Z, U, V) extents and (base, sz, su, sv): the voxel index of sweep
    coordinates (z, u, v) in the ``[X,Y,Z]`` row-major grid is
    ``base + z*sz + u*su + v*sv``."""
    X, Y, Z = world_size
    stride = (Y * Z, Z, 1)
    p = perm(axis)
    dims = tuple(int(world_size[i]) for i in p)
    sz, su, sv = (stride[i] for i in p)
    base = 0
    if flip:
        base, sz = (dims[0] - 1) * sz, -sz
    return dims, (base, sz, su, sv)


def prepare_frame_box(cfg, H: int, W: int, K, c2w, *, stepsize: float,
                      near: float, inverse_y: bool = False,
                      flip_x: bool = False, flip_y: bool = False,
                      device) -> BoxFrame:
    """Rays of one camera -> the per-ray affine of the sweep.

    The sweep axis is the grid axis with the largest worst-case advance per
    step over the rays that hit the box (the JAX package's ``_axis_stats``),
    flipped when those rays run against it."""
    ro, rd, vd = ray_ops.get_rays_of_a_view(
        H, W, K, c2w, ndc=False, inverse_y=inverse_y, flip_x=flip_x,
        flip_y=flip_y, device=device)
    ro, rd, vd = (t.reshape(-1, 3) for t in (ro, rd, vd))
    mn, mx = as_tensor(cfg.xyz_min, device), as_tensor(cfg.xyz_max, device)
    sizes = as_tensor(cfg.world_size, device)
    stepdist = stepsize * cfg.voxel_size

    t_min, t_max = render.ray_aabb(ro, rd, mn, mx, near, 1e9)
    hit = t_max > t_min
    rnorm = torch.linalg.norm(rd, dim=-1)
    unit = rd / rnorm[:, None]
    dk = unit * stepdist / (mx - mn) * (sizes - 1.0)
    hit3 = hit[:, None]
    sgn = torch.sign(torch.where(hit3, dk, torch.zeros_like(dk)).sum(0))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    min_signed = torch.where(hit3, dk * sgn,
                             torch.full_like(dk, 3e8)).amin(0)
    # one small pull decides the sweep axis on the host
    stats = torch.cat([min_signed, sgn, hit.sum()[None].float()]).tolist()
    axis = max(range(3), key=lambda i: stats[i])
    flip = stats[3 + axis] < 0
    n_hit = int(stats[6])

    n_per = torch.clamp_min(
        torch.ceil((t_max - t_min) * rnorm / stepdist), 1.0)
    start = ro + rd * t_min[:, None]
    aff0 = (start - mn) / (mx - mn) * (sizes - 1.0)
    pz, pu, pv = perm(axis)
    z0, dz = aff0[:, pz], dk[:, pz]
    if flip:
        z0 = (cfg.world_size[pz] - 1) - z0
        dz = -dz
    dz = torch.where(dz.abs() < 1e-8, torch.full_like(dz, 1e-8), dz)
    kmax = torch.clamp_max(n_per - 1.0, float(cfg.n_samples(stepsize) - 1))
    consts = torch.stack([aff0[:, pu], dk[:, pu], aff0[:, pv], dk[:, pv],
                          z0, dz, kmax, torch.zeros_like(z0)], dim=1)
    has_mlp = cfg.rgbnet_dim > 0
    vde = ray_ops.positional_encoding(vd, cfg.viewbase_pe) if has_mlp \
        else vd.new_zeros((vd.shape[0], 0))
    return BoxFrame(consts.contiguous(), vde.contiguous(), axis, flip, n_hit)


_RAY_CHUNK = 1 << 18


def sweep_box_plain(voxels, consts, vde, mlp, *, dims, strides, mask_ch: int,
                    k0_dim: int, act_shift: float, interval: float,
                    fast_thres: float, inv_nref: float, rgb_direct: bool,
                    act_type: str, early_exit: bool = True, mask=None,
                    stats: dict | None = None):
    """Plain sweep over rays ``consts [R, 8]``, ``vde [R, E]``.

    ``voxels [N, Cp]`` float32 or bfloat16 (read as float32) with ``dims``
    and ``strides`` from :func:`grid_strides`; ``mlp`` a list of (w, b),
    empty for a model without rgbnet. A bfloat16 grid also sets the compute
    type (see the module docstring). ``mask`` is the native-resolution
    mask in sweep order (:func:`sweep_mask`) when ``mask_ch < 0``. ``early_exit=False`` keeps
    saturated rays in the march (their weights are zero either way).
    Returns (rgb_feature [R,3], depth [R], alphainv_last [R]). When
    ``stats`` is a dict it receives ``samples`` (samples in range) and
    ``mlp_samples`` (samples with a non-zero weight, the only ones whose
    colour is used). Rays go in chunks of ``_RAY_CHUNK``."""
    R = consts.shape[0]
    dev = consts.device
    rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(R, dtype=torch.float32, device=dev)
    ail = torch.ones(R, dtype=torch.float32, device=dev)
    rnd = round_bf16 if voxels.dtype == torch.bfloat16 else (lambda t: t)
    mlp = [(rnd(w), bias) for w, bias in mlp]
    n_samp = torch.zeros((), dtype=torch.long, device=dev)
    n_mlp = torch.zeros((), dtype=torch.long, device=dev)
    for s in range(0, R, _RAY_CHUNK):
        sl = slice(s, min(s + _RAY_CHUNK, R))
        ns, nm = _sweep_chunk(
            voxels, consts[sl], vde[sl], mlp, rgb[sl], depth[sl], ail[sl],
            dims=dims, strides=strides, mask_ch=mask_ch, k0_dim=k0_dim,
            act_shift=act_shift, interval=interval, fast_thres=fast_thres,
            inv_nref=inv_nref, rgb_direct=rgb_direct,
            act=common.activation(act_type) if mlp else None,
            early_exit=early_exit, mask=mask, rnd=rnd)
        n_samp += ns
        n_mlp += nm
    if stats is not None:
        stats["samples"] = int(n_samp)
        stats["mlp_samples"] = int(n_mlp)
    return rgb, depth, ail


def sweep_mask(mask, axis: int, flip: bool):
    """A native-resolution mask ``[mX,mY,mZ]`` in sweep order
    ``[mZ,mU,mV]``, flipped along the sweep axis with the frame."""
    m = mask.permute(*perm(axis))
    return m.flip(0) if flip else m


def _native_mask(mask, dims, z, u, v):
    """Nearest lookup of a sweep-ordered mask at its own resolution: per
    axis the index ``floor(pos * (m-1)/(n-1) + 0.5)``."""
    idx = []
    for pos, n, m in zip((z, u, v), dims, mask.shape):
        scale = (m - 1) / max(n - 1, 1)
        idx.append(torch.floor(pos * scale + 0.5).long().clamp_(0, m - 1))
    return mask[idx[0], idx[1], idx[2]]


def _sweep_chunk(voxels, consts, vde, mlp, rgb, depth, ail, *, dims, strides,
                 mask_ch, k0_dim, act_shift, interval, fast_thres, inv_nref,
                 rgb_direct, act, early_exit, mask, rnd):
    """Sweep one ray chunk; accumulates into the ``rgb, depth, ail`` views
    (``ail`` holds alphainv_last on return). ``rnd`` rounds the u weights
    and the MLP's inputs and hidden activations to the compute type."""
    Z, U, V = dims
    base, sz, su, sv = strides
    dev = consts.device
    u0, du, v0, dv, z0, dz, kmax = (consts[:, i] for i in range(7))
    t = torch.ones_like(u0)        # running transmittance
    n_samp = torch.zeros((), dtype=torch.long, device=dev)
    n_mlp = torch.zeros((), dtype=torch.long, device=dev)
    n_steps = int(kmax.max()) + 1 if kmax.numel() else 0
    for k in range(n_steps):
        kf = float(k)
        # the sample coordinate s, in float32 as the kernel forms it
        sk = float(np.float32(kf + 0.5) * np.float32(inv_nref))
        live = kmax >= kf
        if early_exit:
            live = live & (t >= render.EARLY_TERM_THRES)
        idx = live.nonzero().squeeze(1)
        if idx.numel() == 0:
            if early_exit and not bool((t >= render.EARLY_TERM_THRES).any()):
                break
            continue
        u = u0[idx] + du[idx] * kf
        v = v0[idx] + dv[idx] * kf
        z = z0[idx] + dz[idx] * kf
        valid = ((u >= 0) & (u <= U - 1) & (v >= 0) & (v <= V - 1)
                 & (z >= 0) & (z <= Z - 1))
        n_samp += valid.sum()
        jf = torch.floor(z).clamp(0, Z - 2)
        uf, vf = torch.floor(u), torch.floor(v)
        # out-of-range samples are dropped by ``valid``; clamp their taps
        uf = uf.clamp(0, U - 1)
        vf = vf.clamp(0, V - 1)
        fz, fu, fv = z - jf, u - uf, v - vf
        wz0 = 1.0 - fz
        wz1 = 1.0 - wz0
        wv0 = 1.0 - fv
        wv1 = 1.0 - wv0
        hu0 = 1.0 - fu
        wu0, wu1 = rnd(hu0)[:, None], rnd(1.0 - hu0)[:, None]
        j, iu0, iv0 = jf.long(), uf.long(), vf.long()
        iu1 = torch.clamp_max(iu0 + 1, U - 1)
        iv1 = torch.clamp_max(iv0 + 1, V - 1)
        pz0 = base + j * sz
        pz1 = base + (j + 1) * sz
        qu0, qu1, qv0, qv1 = iu0 * su, iu1 * su, iv0 * sv, iv1 * sv

        def row(pz, qv):
            return (wu0 * voxels[pz + qu0 + qv].float()
                    + wu1 * voxels[pz + qu1 + qv].float())

        r00, r01 = row(pz0, qv0), row(pz0, qv1)
        r10, r11 = row(pz1, qv0), row(pz1, qv1)
        samp = ((wv0[:, None] * r00 + wv1[:, None] * r01) * wz0[:, None]
                + (wv0[:, None] * r10 + wv1[:, None] * r11) * wz1[:, None])
        if mask_ch >= 0:
            # exact nearest mask: the z plane and the v taps within half a
            # cell select u-blends of the 0/1 channel; floor(. + 0.5) of
            # their sum is the nearest u tap
            near0 = (fz < 0.5)
            m0 = torch.where(near0, r00[:, mask_ch], r10[:, mask_ch])
            m1 = torch.where(near0, r01[:, mask_ch], r11[:, mask_ch])
            mval = torch.floor(torch.floor(wv0 + 0.5) * m0
                               + torch.floor(wv1 + 0.5) * m1 + 0.5) > 0.5
        else:
            mval = _native_mask(mask, dims, z.clamp(0, Z - 1),
                                u.clamp(0, U - 1), v.clamp(0, V - 1))
        alpha = render.raw2alpha(samp[:, 0], act_shift, interval)
        zero = torch.zeros_like(alpha)
        alpha = torch.where(valid & mval, alpha, zero)
        if fast_thres > 0:
            alpha = torch.where(alpha > fast_thres, alpha, zero)
        tc = t[idx]
        w = torch.where(tc >= render.EARLY_TERM_THRES, tc * alpha, zero)
        if fast_thres > 0:
            w = torch.where(w > fast_thres, w, zero)
        t_new = tc * (1.0 - alpha)
        t[idx] = t_new
        alive = tc >= render.EARLY_TERM_THRES
        ail[idx] = torch.where(alive, t_new, ail[idx])
        sel = (w > 0).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        n_mlp += sel.numel()
        ridx = idx[sel]
        feat = samp[sel, 1:1 + k0_dim]
        if not mlp:
            logit = feat
        else:
            h = rnd(torch.cat([feat if rgb_direct else feat[:, 3:],
                               vde[ridx]], dim=-1))
            for li, (wl, bl) in enumerate(mlp):
                h = h @ wl + bl
                if li < len(mlp) - 1:
                    h = rnd(act(h))
            logit = h if rgb_direct else h + feat[:, :3]
        ws = w[sel]
        rgb.index_add_(0, ridx, ws[:, None] * torch.sigmoid(logit))
        depth.index_add_(0, ridx, ws * sk)
    return n_samp, n_mlp


def sweep_kwargs(cfg, frame: BoxFrame, packed: PackedBox, stepsize: float):
    """The keyword arguments of :func:`sweep_box_plain` (and of the
    kernel's wrapper) for one frame of a model."""
    dims, strides = grid_strides(cfg.world_size, frame.axis, frame.flip)
    return dict(
        dims=dims, strides=strides, mask_ch=packed.mask_ch,
        k0_dim=cfg.k0_dim, act_shift=float(cfg.act_shift),
        interval=float(stepsize * cfg.voxel_size_ratio),
        fast_thres=float(cfg.fast_color_thres),
        inv_nref=1.0 / cfg.n_samples_ref(stepsize),
        rgb_direct=bool(cfg.rgbnet_direct), act_type=cfg.act_type)


def background(H: int, W: int, bg: float, device) -> dict:
    """The maps of a frame none of whose rays hits the box."""
    return {
        "rgb_marched": torch.full((H, W, 3), float(bg), device=device),
        "rgb_feature": torch.zeros((H, W, 3), device=device),
        "depth": torch.zeros((H, W), device=device),
        "alphainv_last": torch.ones((H, W), device=device),
    }


def render_frame_box(cfg, params, buffers, H: int, W: int, K, c2w, *,
                     stepsize: float, near: float, bg: float,
                     inverse_y: bool = False, flip_x: bool = False,
                     flip_y: bool = False, use_bf16: bool = True,
                     early_exit: bool = True, device=None,
                     packed: PackedBox | None = None,
                     stats: dict | None = None) -> dict:
    """Full-frame bounded-scene render through :func:`sweep_box_plain`
    (any device). Returns ``rgb_marched``, ``rgb_feature`` ``[H,W,3]``,
    ``depth`` and ``alphainv_last`` ``[H,W]``."""
    check_model(cfg)
    dev = resolve_device(device)
    frame = prepare_frame_box(cfg, H, W, K, c2w, stepsize=stepsize,
                              near=near, inverse_y=inverse_y, flip_x=flip_x,
                              flip_y=flip_y, device=dev)
    if frame.n_hit == 0:
        return background(H, W, bg, dev)
    if packed is None:
        packed = pack_box(cfg, params, buffers,
                          dtype=torch.bfloat16 if use_bf16 else torch.float32)
    mlp = mlp_layers(params["rgbnet"]) if cfg.rgbnet_dim > 0 else []
    rgb, depth, ail = sweep_box_plain(
        packed.voxels, frame.consts, frame.vde, mlp,
        **sweep_kwargs(cfg, frame, packed, stepsize), early_exit=early_exit,
        mask=None if packed.mask is None
        else sweep_mask(packed.mask, frame.axis, frame.flip), stats=stats)
    return assemble(rgb, depth, ail, H, W, bg)
