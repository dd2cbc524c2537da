"""Bounded-scene sweep: the eval form, the plain PyTorch version of the box
kernel; and the training form of a pixel patch (``patch_box``, at the
end: :func:`sweep_rays_train_box` with its plans), the JAX package's XLA
slab sweep with autograd.

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
kernel's frame renderer refuses it). :func:`render_frame_box` with a
``tile_mesh`` renders a frame over the ranks of a mesh axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourk_nerf_torch.device import as_tensor, resolve_device
from fourk_nerf_torch.models import common
from fourk_nerf_torch.ops import rays as ray_ops, render
from fourk_nerf_torch.ops.plane_sweep import _mlp_bf16, assemble, \
    mlp_layers, round_bf16


_EPSK = 5e-3   # the slot range's ceil guard against float32 rounding
_S_MAX = 24    # most slots a slab before a plan is refused
_BIG = 3e8


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


def _axis_stats_rays(cfg, ro, rd, *, stepdist: float, near: float) -> list:
    """The sweep axis's statistics of rays ``[N, 3]`` as host floats: per
    grid axis the worst-case signed advance per step over the rays that
    hit the box (3), the sign of the rays' mean advance (3), and the count
    of hitting rays: one small pull (the JAX package's ``_axis_stats``)."""
    dev = ro.device
    mn, mx = as_tensor(cfg.xyz_min, dev), as_tensor(cfg.xyz_max, dev)
    sizes = as_tensor(cfg.world_size, dev)
    t_min, t_max = render.ray_aabb(ro, rd, mn, mx, near, 1e9)
    hit = t_max > t_min
    unit = rd / torch.linalg.norm(rd, dim=-1)[:, None]
    dk = unit * stepdist / (mx - mn) * (sizes - 1.0)
    hit3 = hit[:, None]
    sgn = torch.sign(torch.where(hit3, dk, torch.zeros_like(dk)).sum(0))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    min_signed = torch.where(hit3, dk * sgn,
                             torch.full_like(dk, _BIG)).amin(0)
    return torch.cat([min_signed, sgn, hit.sum()[None].float()]).tolist()


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

    stats = _axis_stats_rays(cfg, ro, rd, stepdist=stepdist, near=near)
    axis = max(range(3), key=lambda i: stats[i])
    flip = stats[3 + axis] < 0
    n_hit = int(stats[6])

    t_min, t_max = render.ray_aabb(ro, rd, mn, mx, near, 1e9)
    rnorm = torch.linalg.norm(rd, dim=-1)
    unit = rd / rnorm[:, None]
    dk = unit * stepdist / (mx - mn) * (sizes - 1.0)
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
                     stats: dict | None = None, tile_mesh=None,
                     tile_axis: str = "data") -> dict:
    """Full-frame bounded-scene render through :func:`sweep_box_plain`
    (any device). Returns ``rgb_marched``, ``rgb_feature`` ``[H,W,3]``,
    ``depth`` and ``alphainv_last`` ``[H,W]``.

    ``tile_mesh`` (a ``parallel.mesh.make_mesh`` mesh) renders the frame
    over the ranks of its ``tile_axis``: the rays, in the 16x8-pixel tile
    order of the kernel's frame driver, are cut into equal shares; each
    rank sweeps its share through ``cuda_box.sweep_box`` (the box kernel
    on the card, :func:`sweep_box_plain` on the CPU) and the shares are
    all-gathered in the axis's process group. The grid then takes the
    kernel's packing (``cuda_box.pack_box_kernel``: a mask at another
    resolution than the grid is refused). A ray's sweep does not depend on
    the others', so the frame equals the one rank's frame of
    ``cuda_box.render_frame_box_cuda`` exactly."""
    check_model(cfg)
    dev = resolve_device(device)
    frame = prepare_frame_box(cfg, H, W, K, c2w, stepsize=stepsize,
                              near=near, inverse_y=inverse_y, flip_x=flip_x,
                              flip_y=flip_y, device=dev)
    if frame.n_hit == 0:
        return background(H, W, bg, dev)
    mlp = mlp_layers(params["rgbnet"]) if cfg.rgbnet_dim > 0 else []
    if tile_mesh is not None:
        return _render_sharded(cfg, params, buffers, frame, mlp, H, W,
                               stepsize=stepsize, bg=bg, use_bf16=use_bf16,
                               packed=packed, mesh=tile_mesh,
                               axis=tile_axis)
    if packed is None:
        packed = pack_box(cfg, params, buffers,
                          dtype=torch.bfloat16 if use_bf16 else torch.float32)
    rgb, depth, ail = sweep_box_plain(
        packed.voxels, frame.consts, frame.vde, mlp,
        **sweep_kwargs(cfg, frame, packed, stepsize), early_exit=early_exit,
        mask=None if packed.mask is None
        else sweep_mask(packed.mask, frame.axis, frame.flip), stats=stats)
    return assemble(rgb, depth, ail, H, W, bg)


def _render_sharded(cfg, params, buffers, frame: BoxFrame, mlp, H: int,
                    W: int, *, stepsize: float, bg: float, use_bf16: bool,
                    packed: PackedBox | None, mesh, axis: str) -> dict:
    """:func:`render_frame_box` over the ranks of ``mesh``'s ``axis``."""
    import torch.distributed as dist
    from fourk_nerf_torch.ops import cuda_box
    from fourk_nerf_torch.ops.cuda_sweep import ray_order

    if packed is None:
        packed = cuda_box.pack_box_kernel(cfg, params, buffers,
                                          use_bf16=use_bf16)
    group = mesh.get_group(axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    order, inverse = ray_order(H, W, frame.consts.device)
    R = order.numel()
    per = -(-R // n)
    mine = torch.cat([order, order[:n * per - R]])[rank * per:
                                                   (rank + 1) * per]
    rgb, depth, ail = cuda_box.sweep_box(
        packed, frame.consts[mine], frame.vde[mine].contiguous(), mlp,
        **sweep_kwargs(cfg, frame, packed, stepsize))
    local = torch.cat([rgb, depth[:, None], ail[:, None]], 1).contiguous()
    got = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(got, local, group=group)
    out = torch.cat(got)[:R][inverse]
    return assemble(out[:, :3], out[:, 3], out[:, 4], H, W, bg)


# ---------------------------------------------------------------------------
# the training form: a differentiable slab sweep of one pixel patch
# ---------------------------------------------------------------------------

def _round_up8(v: float) -> int:
    return int(np.ceil(float(v) / 8.0) * 8)


def box_train_plan(cfg, ro, rd, *, stepsize: float, near: float):
    """The static sweep plan ``(axis, flip, S)`` of a ray batch (any
    leading shape, ``[..., 3]``): the axis along which the rays that hit
    the box advance fastest, whether they run against it, and the slots a
    slab (``ceil(1 / advance) + 2``, rounded up to a multiple of 4); None
    when no ray hits the box or the advance is too small for ``_S_MAX``
    slots (the trainer then takes the gather forward)."""
    stats = _axis_stats_rays(cfg, ro.reshape(-1, 3), rd.reshape(-1, 3),
                             stepdist=stepsize * cfg.voxel_size, near=near)
    min_signed, sgn, n_hit = stats[:3], stats[3:6], stats[6]
    if n_hit == 0:
        return None
    axis = int(np.argmax(min_signed))
    mdz = float(min_signed[axis])
    if mdz <= 1.0 / (_S_MAX - 2):
        return None
    S = int(np.ceil(1.0 / mdz)) + 2
    return axis, bool(sgn[axis] < 0), -(-S // 4) * 4


def _prep_core(cfg, ro, rd, vd, *, axis: int, flip: bool, stepsize: float,
               near: float, vpe: int) -> dict:
    """Per-ray sweep inputs of tiled rays ``[T, R, 3]`` in sweep order
    (the JAX package's ``_prep_core``): the entry point ``start`` and unit
    direction ``unit`` with the sweep axis first, the sample count
    ``n_per``, the viewdir embedding ``vde``, the sweep-axis affine
    ``z0 + dz * k`` (flipped with the plan), ``kmax``, and per (slab, tile)
    the minima ``wmin [Z-1, T, 2]`` of the (u, v) footprint of the tile's
    rays that reach the slab, and the largest footprint ``spread [2]``."""
    p = perm(axis)
    Z, U, V = (cfg.world_size[i] for i in p)
    stepdist = stepsize * cfg.voxel_size
    K = cfg.n_samples(stepsize)
    dev = ro.device
    mn_all = as_tensor(cfg.xyz_min, dev)
    mx_all = as_tensor(cfg.xyz_max, dev)
    t_min, t_max = render.ray_aabb(ro, rd, mn_all, mx_all, near, 1e9)
    hit_fp = t_max > t_min  # strict: rays grazing the box add no footprint
    rnorm = torch.linalg.norm(rd, dim=-1)
    n_per = torch.clamp_min(torch.ceil(render.true_div(
        (t_max - t_min) * rnorm, stepdist)), 1.0)
    start = ro + rd * t_min[..., None]
    unit = rd / rnorm[..., None]
    vde = ray_ops.positional_encoding(vd, vpe) if vpe else vd
    pl = list(p)
    start_p, unit_p = start[..., pl], unit[..., pl]
    mn, mx = mn_all[pl], mx_all[pl]
    sz = as_tensor([Z, U, V], dev)
    aff0 = (start_p - mn) / (mx - mn) * (sz - 1.0)
    dk = unit_p * stepdist / (mx - mn) * (sz - 1.0)
    z0, dz = aff0[..., 0], dk[..., 0]
    if flip:
        z0 = (Z - 1) - z0
        dz = -dz
    dz = torch.where(dz.abs() < 1e-8, torch.full_like(dz, 1e-8), dz)
    u0, du = aff0[..., 1], dk[..., 1]
    v0, dv = aff0[..., 2], dk[..., 2]
    kmax = torch.clamp_max(n_per - 1.0, float(K - 1))
    big = torch.full_like(u0, _BIG)
    wmin, wmax = [], []
    # the slabs in chunks of about 16M (slab, ray) pairs
    step = max(1, (1 << 24) // max(u0.numel(), 1))
    for j0 in range(0, Z - 1, step):
        j = torch.arange(j0, min(j0 + step, Z - 1), dtype=torch.float32,
                         device=dev)[:, None, None]
        ka_r = (j - z0) / dz
        kb_r = (j + 1.0 - z0) / dz
        ka = torch.minimum(torch.clamp_min(torch.ceil(ka_r - _EPSK), 0.0),
                           kmax)
        kb = torch.minimum(torch.clamp_min(kb_r, 0.0), kmax)
        # a ray whose samples miss this slab adds no footprint
        active = hit_fp & (torch.minimum(kb_r, kmax + 1.0)
                           >= torch.clamp_min(ka_r, 0.0) - 0.5)
        lo, hi = [], []
        for o, d in ((u0, du), (v0, dv)):
            a, b = o + d * ka, o + d * kb
            lo.append(torch.where(active, torch.minimum(a, b), big).amin(2))
            hi.append(torch.where(active, torch.maximum(a, b),
                                  -big).amax(2))
        wmin.append(torch.stack(lo, -1))
        wmax.append(torch.stack(hi, -1))
    wmin, wmax = torch.cat(wmin), torch.cat(wmax)     # [Z-1, T, 2]
    spread = torch.clamp_min(wmax - wmin, 0.0).amax(dim=(0, 1))
    return dict(start_p=start_p, unit_p=unit_p, n_per=n_per, vde=vde, z0=z0,
                dz=dz, kmax=kmax, wmin=wmin, spread=spread)


def box_window_size_for(cfg, ro, rd, vd, *, stepsize: float, near: float,
                        axis: int, flip: bool, cap: int = 64):
    """The static slab window ``(Pu, Pv)`` of a ray batch ``[R, 3]`` or of
    tiled patches ``[T, R, 3]`` (the largest footprint over slabs and
    tiles, plus the hat margins, rounded up to 8, at least 16, at most the
    grid); None when it exceeds ``cap`` (the trainer then takes the gather
    forward)."""
    tile3 = (lambda x: x) if ro.dim() == 3 else (lambda x: x.reshape(1, -1,
                                                                     3))
    spread = _prep_core(cfg, tile3(ro), tile3(rd), tile3(vd), axis=axis,
                        flip=flip, stepsize=stepsize, near=near,
                        vpe=0)["spread"].tolist()
    p = perm(axis)
    U, V = cfg.world_size[p[1]], cfg.world_size[p[2]]
    Pu = min(U, max(16, _round_up8(spread[0] + 4)))
    Pv = min(V, max(16, _round_up8(spread[1] + 4)))
    if Pu > cap or Pv > cap:
        return None
    return Pu, Pv


def _mask_plane_plan(Z: int, mZ: int):
    """The native-resolution mask planes each slab reads: slab j's samples
    have a sweep coordinate in about ``[j, j + 1]``, so their nearest mask
    plane lies in ``[nearest(j * s) - 1, nearest((j + 1) * s) + 1]``
    (``s`` the mask's planes a grid plane). Returns (first plane
    ``[Z-1]``, planes a slab)."""
    msz = (mZ - 1) / max(Z - 1, 1)
    j = np.arange(Z - 1, dtype=np.float64)
    base = np.floor(j * msz + 0.5).astype(np.int64) - 1
    top = np.floor((j + 1) * msz + 0.5).astype(np.int64) + 1
    return base, int(np.max(top - base)) + 1


def _hat_taps(rel, last):
    """The two linear-hat taps of positions ``rel`` in a window whose last
    tap is ``last`` (a number or, per sample, a tensor: the window's ``P``
    taps, or fewer where the grid ends inside it): [(tap, weight)] with
    the weight ``max(0, 1 - |rel - tap|)``, 0 for a tap outside the window
    (its index clamped into it)."""
    t0 = torch.floor(rel)
    out = []
    for t in (t0, t0 + 1.0):
        w = torch.clamp_min(1.0 - (rel - t).abs(), 0.0)
        inside = (t >= 0) & (t <= last)
        out.append((torch.minimum(t.clamp_min(0), torch.as_tensor(
            last, dtype=t.dtype, device=t.device)).long(),
                    torch.where(inside, w, torch.zeros_like(w))))
    return out


def _nearest_tap(rel, last):
    """(tap, inside) of the snapped one-hot of positions ``rel``: the tap
    with ``rel - tap`` in ``[-0.5, 0.5)``, and whether it lies in the
    window whose last tap is ``last`` (as :func:`_hat_taps`)."""
    c = torch.floor(rel + 0.5)
    d = rel - c
    c = torch.where(d < -0.5, c - 1.0, torch.where(d >= 0.5, c + 1.0, c))
    inside = (c >= 0) & (c <= last)
    return torch.minimum(c.clamp_min(0), torch.as_tensor(
        last, dtype=c.dtype, device=c.device)).long(), inside


def sweep_rays_train_box(cfg, params, buffers, rays_o, rays_d, viewdirs, *,
                         stepsize: float, near: float, bg: float, axis: int,
                         flip: bool, S: int, Pu: int, Pv: int,
                         bg_noise=None, rand_bkgd: bool = False,
                         is_train: bool = True, use_bf16: bool = True,
                         stats: dict | None = None, **unused) -> dict:
    """Differentiable slab-sweep render of one pixel patch ``[R, 3]`` for
    bounded-scene training: the JAX package's ``sweep_rays_train_box``
    (its XLA ``_sweep(train=True)``), with autograd of plain torch ops.

    Each grid slab ``j`` of the plan's sweep axis holds the slots
    ``k_lo(j) + 0..S-1`` of every ray; a slot is a sample of the slab when
    ``floor(z_aff) == j`` (its affine sweep coordinate), in the box by its
    world point, within the ray's count and the mask (exact nearest
    neighbour, the mask as a grid channel or at its own resolution).
    Alpha, the pre-transmittance gate, the weight threshold and
    ``alphainv_last`` at the last alive slot follow ``alpha2weight`` on
    the slab-major slot order. The output dict is ``dvgo.forward``'s with
    ``K' = (Z-1) * S`` slots in that order (``weights``, ``raw_rgb``,
    ``s`` ``[R, K']``): each global sample index sits in one slot, the
    others weigh 0, so every encoder loss reads it unchanged.

    Where it differs from the TPU form, and why:
    - The trilinear sample gathers the eight corners of each sample
      (``index_select``) where the TPU form contracts hat weights over a
      ``Pu x Pv`` window of the two planes (which exists to avoid
      gathers). A corner outside the window (origin ``floor(wmin) - 1``,
      clamped) contributes 0 as its hat weight does, so the function is
      the same; the sums of the contraction run in another order (rounding
      apart).
    - The rgbnet runs on the slots with a non-zero weight only and is
      scattered into the dense layout: at full width (160^3, 88x88 rays,
      S 8) the ~10M slots' activations would take ~12 GB for the backward.
      ``raw_rgb`` of a weight-0 slot is then 0 where the TPU form has a
      value no loss term reads (its gradient is 0 either way).
    - ``use_bf16`` rounds where the TPU form rounds: the u hat weights,
      the grid values, the rgbnet's input, weights and hidden sums
      (``plane_sweep._mlp_bf16``); ``use_bf16=False`` is float32 through.

    ``axis, flip, S`` come from :func:`box_train_plan`, ``Pu, Pv`` from
    :func:`box_window_size_for`. With ``rand_bkgd`` and ``is_train`` the
    background is ``bg_noise [R, 3]``. When ``stats`` is a dict it receives
    ``slots`` (``R * K'``), ``samples`` (the slots sampled: in the box, in
    the mask, alpha above the threshold) and ``mlp_samples`` (those with a
    non-zero weight, the rgbnet's rows)."""
    check_model(cfg)
    dev = rays_o.device
    has_mlp = cfg.rgbnet_dim > 0
    prep = _prep_core(cfg, rays_o[None], rays_d[None], viewdirs[None],
                      axis=axis, flip=flip, stepsize=stepsize, near=near,
                      vpe=cfg.viewbase_pe if has_mlp else 0)
    start_p, unit_p, n_per, vde, z0, dz, kmax = (
        prep[k][0] for k in ("start_p", "unit_p", "n_per", "vde", "z0",
                             "dz", "kmax"))
    wmin = prep["wmin"][:, 0]                                  # [J, 2]
    dims, strides = grid_strides(cfg.world_size, axis, flip)
    Z, U, V = dims
    J, R = Z - 1, rays_o.shape[0]
    K = cfg.n_samples(stepsize)
    n_ref = cfg.n_samples_ref(stepsize)
    stepdist = stepsize * cfg.voxel_size
    interval = stepsize * cfg.voxel_size_ratio
    fct = float(cfg.fast_color_thres)
    kdim = cfg.k0_dim
    rnd = round_bf16 if use_bf16 else (lambda t: t)
    pl = list(perm(axis))
    mn = as_tensor(cfg.xyz_min, dev)[pl]
    mx = as_tensor(cfg.xyz_max, dev)[pl]
    sz = as_tensor(dims, dev)

    # --- the slots: [J, R, S] -------------------------------------------------
    js = torch.arange(J, dtype=torch.float32, device=dev)
    k_lo = torch.minimum(torch.clamp_min(torch.ceil(
        (js[:, None] - z0) / dz - _EPSK), 0.0), kmax)           # [J, R]
    ks = k_lo[..., None] + torch.arange(S, dtype=torch.float32, device=dev)
    pts = start_p[:, None, :] + unit_p[:, None, :] * (stepdist * ks)[..., None]
    in_bbox = ((pts >= mn) & (pts <= mx)).all(-1)
    pos = (pts - mn) / (mx - mn) * (sz - 1.0)
    zp = (Z - 1) - pos[..., 0] if flip else pos[..., 0]
    z_aff = z0[:, None] + dz[:, None] * ks
    member = torch.clamp(torch.floor(z_aff), 0.0, float(Z - 2)) \
        == js[:, None, None]
    pre = member & in_bbox & (ks < n_per[:, None]) & (ks < K)
    flat = pre.reshape(-1).nonzero().squeeze(1)           # slab-major slots
    j_i = torch.div(flat, R * S, rounding_mode="floor")
    r_i = torch.div(flat, S, rounding_mode="floor") % R
    uf, vf, zf = (t.reshape(-1)[flat] for t in (pos[..., 1], pos[..., 2],
                                                 zp))
    jf = j_i.float()
    # the window's origin; a window wider than this sweep's extent (the
    # stage's window serves views that sweep other axes) starts at 0 and
    # ends with the grid
    ou = torch.clamp(torch.floor(wmin[:, 0]).long() - 1, 0,
                     max(U - Pu, 0))[j_i]
    ov = torch.clamp(torch.floor(wmin[:, 1]).long() - 1, 0,
                     max(V - Pv, 0))[j_i]
    last_u = (U - 1 - ou).clamp_max(Pu - 1)
    last_v = (V - 1 - ov).clamp_max(Pv - 1)
    rel_u, rel_v = uf - ou.float(), vf - ov.float()

    # --- the free-space mask, exact nearest neighbour -------------------------
    mask = buffers["mask_cache"]
    if tuple(mask.shape) == tuple(cfg.world_size):
        (cu, iu), (cv, iv) = (_nearest_tap(rel_u, last_u),
                              _nearest_tap(rel_v, last_v))
        g0 = (zf - jf >= -0.5) & (zf - jf < 0.5)
        plane = torch.where(g0, j_i, j_i + 1)
        base, s_z, s_u, s_v = strides
        mval = mask.reshape(-1)[base + plane * s_z + (ou + cu) * s_u
                                + (ov + cv) * s_v] & iu & iv
    else:
        mdims, mstr = grid_strides(mask.shape, axis, flip)
        mZ, mU, mV = mdims
        base_np, Wm = _mask_plane_plan(Z, mZ)
        mPu = min(mU, _round_up8(min(Pu, U) * (mU - 1) / max(U - 1, 1) + 5))
        mPv = min(mV, _round_up8(min(Pv, V) * (mV - 1) / max(V - 1, 1) + 5))
        msu = (mU - 1) / max(U - 1, 1)
        msv = (mV - 1) / max(V - 1, 1)
        msz = (mZ - 1) / max(Z - 1, 1)
        oum = torch.clamp(torch.floor(wmin[:, 0] * msu).long() - 1, 0,
                          mU - mPu)[j_i]
        ovm = torch.clamp(torch.floor(wmin[:, 1] * msv).long() - 1, 0,
                          mV - mPv)[j_i]
        base_j = torch.as_tensor(base_np, device=dev)[j_i]
        cz, iz = _nearest_tap(zf * msz - base_j.float(), Wm - 1)
        cu, iu = _nearest_tap(uf * msu - oum.float(), mPu - 1)
        cv, iv = _nearest_tap(vf * msv - ovm.float(), mPv - 1)
        mb, ms_z, ms_u, ms_v = mstr
        mval = mask.reshape(-1)[
            mb + torch.clamp(base_j + cz, 0, mZ - 1) * ms_z
            + (oum + cu) * ms_u + (ovm + cv) * ms_v] & iz & iu & iv
    keep = mval.nonzero().squeeze(1)
    flat, j_i, r_i = flat[keep], j_i[keep], r_i[keep]
    rel_u, rel_v, zf, jf, ou, ov, last_u, last_v = (
        t[keep] for t in (rel_u, rel_v, zf, jf, ou, ov, last_u, last_v))

    # --- the trilinear sample of the kept slots: 8 gathered corners -----------
    base, s_z, s_u, s_v = strides
    dens = params["density"].reshape(-1, 1)
    k0 = params["k0"].reshape(-1, kdim)
    hu = [(ou + t, rnd(w)) for t, w in _hat_taps(rel_u, last_u)]
    hv = [(ov + t, w) for t, w in _hat_taps(rel_v, last_v)]
    samp = 0.0
    for dzp in (0, 1):
        wz = torch.clamp_min(1.0 - (zf - (jf + dzp)).abs(), 0.0)
        zoff = base + (j_i + dzp) * s_z
        acc_v = 0.0
        for iv_, wv in hv:
            row = 0.0
            for iu_, wu in hu:
                idx = zoff + iu_ * s_u + iv_ * s_v
                vals = torch.cat([dens.index_select(0, idx),
                                  k0.index_select(0, idx)], 1)
                row = row + wu[:, None] * rnd(vals)
            acc_v = acc_v + wv[:, None] * row
        samp = samp + wz[:, None] * acc_v
    alpha = render.raw2alpha(samp[:, 0], cfg.act_shift, interval)
    if fct > 0:
        live = (alpha > fct).nonzero().squeeze(1)
        flat, j_i, r_i, alpha, samp = (t[live] for t in (flat, j_i, r_i,
                                                         alpha, samp))

    # --- alpha2weight on the slab-major slot order -----------------------------
    alphav = torch.zeros(J * R * S, device=dev).index_put(
        (flat,), alpha).reshape(J, R, S)
    cp_ = torch.cumprod(1.0 - alphav, dim=2)
    t_cum = torch.cat([torch.ones_like(cp_[:1, :, -1]),
                       torch.cumprod(cp_[:, :, -1], dim=0)[:-1]])  # [J, R]
    t_pre = t_cum[..., None] * torch.cat(
        [torch.ones_like(cp_[..., :1]), cp_[..., :-1]], dim=2)
    t_post = t_cum[..., None] * cp_
    alive = t_pre >= render.EARLY_TERM_THRES
    zero = torch.zeros_like(t_pre)
    wgt = torch.where(alive, t_pre * alphav, zero)
    if fct > 0:
        wgt = torch.where(wgt > fct, wgt, zero)
    order = (1, 0, 2)                                # slab-major per ray
    weights = wgt.permute(*order).reshape(R, J * S)
    last = alive.permute(*order).reshape(R, J * S).sum(1) - 1
    ail = t_post.permute(*order).reshape(R, J * S).gather(
        1, last[:, None])[:, 0]

    # --- colour on the slots with a non-zero weight ----------------------------
    w_flat = wgt.reshape(-1)
    on = (w_flat[flat] > 0).nonzero().squeeze(1)
    feat = samp[on, 1:1 + kdim]
    r_on = r_i[on]
    if not has_mlp:
        rgb = torch.sigmoid(feat)
    else:
        x = torch.cat([feat if cfg.rgbnet_direct else feat[:, 3:],
                       vde[r_on]], 1)
        act = common.activation(cfg.act_type or "relu")
        logit = (_mlp_bf16(params["rgbnet"], x, act).float() if use_bf16
                 else common.mlp_apply(params["rgbnet"], x, act))
        rgb = torch.sigmoid(logit if cfg.rgbnet_direct
                            else logit + feat[:, :3])
    w_on = w_flat[flat[on]]
    if stats is not None:
        stats.update(slots=J * R * S, samples=int(flat.numel()),
                     mlp_samples=int(on.numel()))
    rgb_acc = torch.zeros((R, 3), device=dev).index_add(
        0, r_on, w_on[:, None] * rgb)
    raw_rgb = torch.zeros((J * R * S, 3), device=dev).index_put(
        (flat[on],), rgb).reshape(J, R, S, 3).permute(1, 0, 2, 3).reshape(
        R, J * S, 3)
    s = render.true_div(ks + 0.5, n_ref).permute(*order).reshape(R, J * S)
    with torch.no_grad():
        depth = (weights * s).sum(1)
    rgb_m = rgb_acc + ail[:, None] * bg
    rgb_feature = rgb_m - ail[:, None] * bg
    if rand_bkgd and is_train:
        if bg_noise is None:
            raise ValueError("rand_bkgd training needs bg_noise")
        rgb_marched = rgb_feature + ail[:, None] * bg_noise
    else:
        rgb_marched = rgb_feature + ail[:, None] * bg
    return {"alphainv_last": ail, "weights": weights,
            "rgb_marched": rgb_marched, "rgb_feature": rgb_feature,
            "raw_rgb": raw_rgb, "n_max": n_ref, "s": s.detach(),
            "depth": depth}
