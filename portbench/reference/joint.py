"""The reference's joint step of 4K-NeRF (frozoul/4K-NeRF ``run_sr.py:884-1011``,
the L1 stage of ``configs/llff/fern_lg_joint_l1.py``), in plain PyTorch: the
VC-Encoder (DirectMPIGO) renders a low-resolution pixel patch, the
VC-Decoder (``reference/sftnet.py``) decodes it x4 under its depth
condition, and one loss trains both; the gradients come from autograd,
then MaskedAdam updates the grids and a plain Adam the rgbnet and every
generator leaf.

Precision, as the configuration states it: float32 with TF32 off, but for
the encoder's patch sweep, which rounds to bfloat16 at fixed points (a
rounding of this file's own, :func:`round_bf16`): the grid values read
(their gradient passes straight through in float32), the bilinear x
weights, and the rgbnet, whose inputs, weights, biases, products and
hidden activations are bfloat16 and whose gradients come from bfloat16
products (:class:`_LinearBF16`: each product's operands and result
rounded, accumulated in float32).

Departures from ``run_sr.py``, each the port's and the JAX package's
choice, which the configuration states:

- the encoder renders the patch on the NDC planes, sample k of a ray on
  plane k at grid position ``a + b k`` (affine in k), with the hat weights
  ``1 - |p - i|``; a tap outside the grid counts zero;
- the occupancy mask is read through the same taps (the sweep's CHANNEL
  mode): a sample is occupied where the mask interpolated with the x
  weights as rounded and the y weights snapped to the nearest cell rounds
  to one, so along x the nearest cell is the one the rounded weights
  favour, and a tie is occupied if either cell is;
- no z test: sample k lies on plane k by construction;
- the photometric term is the L1 of ``rgb_feature`` (the patch without a
  background), so the step's random background enters no loss;
- the depth condition is detached: no gradient reaches the encoder
  through it;
- TV (before ``tv_before``) is scaled by the view count, not the ray count.

The rgbnet runs only on the samples with a non-zero weight: any other
sample's colour enters the composite and the per-point loss multiplied by
a zero weight. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from portbench.reference import common as C
from portbench.reference import dmpigo as D
from portbench.reference import sftnet
from portbench.reference import train as T

ENCODER = ("density", "k0", "rgbnet")
MASKED = {"density", "k0"}


def round_bf16(x):
    """float32 values rounded to the nearest bfloat16, kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _RoundST(torch.autograd.Function):
    """Rounded to bfloat16 going forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBoth(torch.autograd.Function):
    """Rounded to bfloat16 going forward and its gradient rounded going
    back: a bfloat16 bias added in float32."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


class _LinearBF16(torch.autograd.Function):
    """``x @ w`` of bfloat16 operands, summed in float32 and rounded to
    bfloat16; going back the incoming gradient is rounded, and so is each
    of the two products it makes."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        return round_bf16(xr @ wr)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        g = round_bf16(g)
        return round_bf16(g @ wr.t()), round_bf16(xr.t() @ g)


class _RoundTF32(torch.autograd.Function):
    """Rounded to TF32 going forward; the gradient passes through (the
    control's conv operands)."""

    @staticmethod
    def forward(ctx, x):
        return C.round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def tf32_operands(x):
    return _RoundTF32.apply(x)


def mlp_bf16(p: dict, x):
    """The rgbnet in bfloat16: ReLU between layers, the last layer's sum
    in float32."""
    n = len(p) // 2
    x = _RoundST.apply(x)
    for i in range(n):
        y = _LinearBF16.apply(x, p[f"w{i}"]) + _RoundBoth.apply(p[f"b{i}"])
        if i < n - 1:
            x = torch.relu(_RoundST.apply(y))
    return y


def _hat(p, n: int):
    """The two taps of positions ``p`` along an axis of ``n`` cells:
    (i0, i1 clamped into the axis, w0, w1), a weight 0 where its tap lies
    outside."""
    f = torch.floor(p)
    fr = p - f
    w0 = 1.0 - fr
    w1 = 1.0 - (fr - 1.0).abs()
    i0 = f.long()
    i1 = i0 + 1
    zero = torch.zeros_like(w0)
    w0 = torch.where((i0 >= 0) & (i0 < n), w0, zero)
    w1 = torch.where((i1 >= 0) & (i1 < n), w1, zero)
    return i0.clamp(0, n - 1), i1.clamp(0, n - 1), w0, w1


def render_patch(model: dict, params: dict, buffers: dict, ro, rd, vd):
    """The encoder's render of rays ``[N, 3]`` over the whole grid:
    ``rgb_feature [N,3]``, ``depth [N]`` (detached), ``alphainv_last``,
    the dense ``weights [N,Z]`` and ``s``, ``n_max``, the colours
    ``rgb_w`` of the weighted samples ``sel`` (flat indices into
    ``[N*Z]``), and the counts ``valid`` and ``weighted``."""
    density, k0 = params["density"], params["k0"]
    X, Y, Z, Ck = k0.shape
    dev = ro.device
    lo = torch.tensor(model["xyz_min"], dtype=torch.float32, device=dev)
    hi = torch.tensor(model["xyz_max"], dtype=torch.float32, device=dev)
    size = torch.tensor([X, Y], dtype=torch.float32, device=dev)
    a = (ro[:, :2] - lo[:2]) / (hi[:2] - lo[:2]) * (size - 1)
    b = rd[:, :2] / (hi[:2] - lo[:2]) * (size - 1) / (Z - 1)
    k = torch.arange(Z, dtype=torch.float32, device=dev)
    px = a[:, :1] + b[:, :1] * k                             # [N, Z]
    py = a[:, 1:] + b[:, 1:] * k
    x0, x1, wx0, wx1 = _hat(px, X)
    y0, y1, wy0, wy1 = _hat(py, Y)
    wx0, wx1 = round_bf16(wx0), round_bf16(wx1)
    kz = torch.arange(Z, device=dev)
    taps = [(x0 * Y + y0) * Z + kz, (x1 * Y + y0) * Z + kz,
            (x0 * Y + y1) * Z + kz, (x1 * Y + y1) * Z + kz]

    def interp(v):
        return (wy0 * (wx0 * v[0] + wx1 * v[1])
                + wy1 * (wx0 * v[2] + wx1 * v[3]))

    d = [_RoundST.apply(density.reshape(-1)[t]) for t in taps]
    dens = interp(d)
    with torch.no_grad():
        m = [buffers["mask_cache"].reshape(-1)[t].float() for t in taps]
        r0 = wx0 * m[0] + wx1 * m[1]
        r1 = wx0 * m[2] + wx1 * m[3]
        occupied = torch.floor(torch.floor(wy0 + 0.5) * r0
                               + torch.floor(wy1 + 0.5) * r1 + 0.5) > 0.5
        inside = (px >= 0) & (px <= X - 1) & (py >= 0) & (py <= Y - 1)
    interval = model["stepsize"] * 256.0 / model["mpi_depth"]
    shift = buffers["act_shift"].reshape(1, Z)
    alpha = C.raw2alpha(dens + shift, 0.0, interval)
    thres = model["fast_color_thres"]
    valid = inside & occupied
    if thres > 0:
        valid = valid & (alpha > thres)
    weights, ail = C.alpha2weight(alpha, valid)
    if thres > 0:
        weights = torch.where(weights > thres, weights,
                              torch.zeros_like(weights))

    sel = (weights.detach().reshape(-1) > 0).nonzero().squeeze(1)
    ray = sel // Z

    def at(t):
        return t.reshape(-1)[sel]

    f = [_RoundST.apply(k0.reshape(-1, Ck)[at(t)]) for t in taps]
    wsel = [at(w)[:, None] for w in (wx0, wx1, wy0, wy1)]
    emb = (wsel[2] * (wsel[0] * f[0] + wsel[1] * f[1])
           + wsel[3] * (wsel[0] * f[2] + wsel[1] * f[3]))
    kk = 2.0 * at(k.expand(ro.shape[0], Z)) / (Z - 1) - 1.0
    pe = torch.stack([kk, at(py) / (Y - 1) * 2.0 - 1.0,
                      at(px) / (X - 1) * 2.0 - 1.0], -1)
    feat = torch.cat([emb, C.positional_encoding(pe, model["spatial_pe"]),
                      C.positional_encoding(vd[ray], model["viewbase_pe"])],
                     -1)
    rgb_w = torch.sigmoid(mlp_bf16(params["rgbnet"], feat))
    w_sel = weights.reshape(-1)[sel]
    # each weighted sample's colour back in its (ray, plane) cell, then a
    # ray's sum in plane order: an index_add would sum them with atomic
    # adds, in another order, and to other roundings, on every run
    cells = torch.zeros((ro.shape[0] * Z, 3), device=dev,
                        dtype=rgb_w.dtype).index_put(
                            (sel,), w_sel[:, None] * rgb_w)
    rgb_feature = cells.reshape(ro.shape[0], Z, 3).sum(1)
    s = ((k + 0.5) / Z)[None, :].expand(ro.shape[0], Z)
    return {"rgb_feature": rgb_feature,
            "depth": (weights * s).sum(-1).detach(),
            "rgb_marched": rgb_feature, "alphainv_last": ail,
            "weights": weights, "s": s, "n_max": Z, "rgb_w": rgb_w,
            "sel": sel, "valid": int(valid.sum()),
            "weighted": int(sel.numel())}


def loss_of(out: dict, sr, target, target_hr, tr: dict, n: int):
    """The joint loss: the photometric L1 of the patch, the L1 of the
    decoded patch against the high-resolution one, and the encoder's
    regularisers (background entropy, distortion, per-point rgb; from
    ``reference/train.py``, its MSE term weighed zero)."""
    photo = tr["weight_main"] * (out["rgb_feature"] - target).abs().mean()
    l1 = (sr - target_hr).abs().mean()
    return photo + l1 + T.loss_of(out, target, {**tr, "weight_main": 0.0},
                                  n)


def step(cfg: dict, params: dict, buffers: dict, opt: dict, batch, lrs: dict,
         *, apply_tv: bool, tv_dense: bool, n_views: int,
         conv_rnd=C.identity):
    """One joint step on ``batch = (rays_o, rays_d, viewdirs, rgb, rgb_hr)``
    (the patch's rays row-major, ``rgb_hr`` its x``scale`` target);
    ``params`` holds ``density``, ``k0``, ``rgbnet`` and the generator
    ``srnet`` (raw names); updates ``params`` and ``opt`` in place.
    ``conv_rnd`` rounds every generator conv's operands (the control).
    Returns (loss, the gradients by leaf name, the forward's counts)."""
    m, dec, tr = cfg["model"], cfg["decoder"], cfg["train"]
    ro, rd, vd, target, target_hr = batch
    n = ro.shape[0]
    p = int(round(n ** 0.5))
    s = dec["scale"]
    names = [nm for nm, _ in T.leaves(params)]
    live = {nm: t.detach().requires_grad_(True) for nm, t in T.leaves(params)}

    def group(g):
        return {nm.split(".", 1)[1]: t for nm, t in live.items()
                if nm.startswith(g + ".")}
    out = render_patch(m, {"density": live["density"], "k0": live["k0"],
                           "rgbnet": group("rgbnet")}, buffers, ro, rd, vd)
    sr = sftnet.forward(group("srnet"), dec,
                        out["rgb_feature"].reshape(1, p, p, 3),
                        out["depth"].reshape(1, p, p, 1), rnd=conv_rnd)
    loss = loss_of(out, sr, target, target_hr.reshape(1, p * s, p * s, 3),
                   tr, n)
    gs = torch.autograd.grad(loss, [live[nm] for nm in names],
                             allow_unused=True)
    grads = {nm: torch.zeros_like(live[nm]) if g is None else g
             for nm, g in zip(names, gs)}
    if apply_tv:
        ws = params["density"].shape[:3]
        for grp, wkey in (("density", "weight_tv_density"),
                          ("k0", "weight_tv_k0")):
            if tr[wkey] > 0:
                wx, wy, wz = D.tv_weights(m, ws, tr[wkey], n_views)
                grads[grp] = grads[grp] + T.tv_grad(
                    params[grp].detach(), wx, wy, wz,
                    None if tv_dense else grads[grp])
    T.adam_step(params, grads, opt, lrs, MASKED)
    counts = {"valid": out["valid"], "weighted": out["weighted"]}
    return float(loss.detach()), grads, counts


def group_lrs(tr: dict, steps_since_reset: int) -> dict:
    """Each group's lr decayed over ``steps_since_reset`` steps: the
    encoder's ``lrate_<group>`` and the generator's ``lrate_srnet``."""
    base = {g: tr[f"lrate_{g}"] for g in ENCODER}
    base["srnet"] = tr["lrate_srnet"]
    return {g: T.group_lr(v, steps_since_reset, tr["lrate_decay"])
            for g, v in base.items() if v > 0}
