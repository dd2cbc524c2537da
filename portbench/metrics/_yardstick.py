"""The yardstick: published H100 peaks and the least work of each kernel
and step, counted from shapes and from the samples the inputs need
(frozen; the arithmetic of the port's ``chip_smoke.py``, copied).

Peaks: NVIDIA H100 SXM data sheet, dense rates at 700 W.
"""

from __future__ import annotations

from portbench.reference import common as C

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# a dense block's five 3x3 convs (input channels, output channels)
DENSE_CONVS = ((64, 32), (96, 32), (128, 32), (160, 32), (192, 64))


def rdb_macs_per_px(nf: int = 64, g: int = 32) -> int:
    """MACs of one dense block per pixel: five 3x3 convs, SFT0 on ``nf``
    channels and SFT1 on ``g`` (each a scale and a shift branch of
    32 -> g -> C, 1x1)."""
    convs = 9 * sum((nf + i * g) * (g if i < 4 else nf) for i in range(5))
    return convs + 2 * (32 * g + g * nf) + 2 * (32 * g + g * g)


def sft_macs(nf: int, g: int) -> int:
    return 2 * (32 * g + g * nf)


def frame_decode_macs(dec: dict, H: int, W: int) -> int:
    """MACs of one SFTNet decode of an ``H x W`` encoder frame."""
    nf, g, nb, s = (dec["num_feat"], dec["num_grow_ch"], dec["num_block"],
                    dec["scale"])
    px = H * W
    lr = (9 * 3 * nf + 9 * dec["num_cond"] * 64 + 64 * 64 * 2 + 64 * 32
          + 3 * nb * rdb_macs_per_px(nf, g) + (nb + 1) * sft_macs(nf, g)
          + 9 * nf * nf)
    macs = lr * px
    conv = 9 * nf * nf
    if s > 1:
        macs += conv * px * 4            # conv_up1 at 2x
    if s == 4:
        macs += conv * px * 16           # conv_up2 at 4x
    macs += (conv + 9 * nf * 3) * px * s * s   # conv_hr, conv_last
    return macs


def mlp_flops(dims) -> int:
    """FLOPs of one rgbnet forward on one sample."""
    return 2 * sum(a * b for a, b in zip(dims, dims[1:]))


def encode_flops(cfg: dict, weighted: float) -> float:
    """The rgbnet on the samples with a non-zero weight."""
    return weighted * mlp_flops(C.rgbnet_dims(cfg["family"], cfg["model"]))


def frame_flops(cfg: dict, weighted: float) -> float:
    cam = cfg["camera"]
    return (2.0 * frame_decode_macs(cfg["decoder"], cam["H"], cam["W"])
            + encode_flops(cfg, weighted))


def sweep_bytes(cfg: dict) -> int:
    """Bytes a frame's sweep must move: the grid's live channels (density,
    k0, mask) in bf16 read once, the per-ray inputs in float32 (the
    plane sweep: ``a, b`` 2 each and the viewdir embedding; the box
    sweep: 8 constants and the embedding), the five output maps."""
    fam, m, cam = cfg["family"], cfg["model"], cfg["camera"]
    X, Y, Z = C.world_size(fam, m)
    rays = cam["H"] * cam["W"]
    vde = 3 + 6 * m["viewbase_pe"]
    per_ray = C.family(fam).RAY_FLOATS + vde
    return (X * Y * Z * (m["rgbnet_dim"] + 2) * 2 + rays * per_ray * 4
            + rays * 5 * 4)


def sweep_bound_s(cfg: dict, weighted: float) -> float:
    """The least time of a frame's sweep: the larger of its bytes at the
    HBM rate and its bf16 MLP at the bf16 peak."""
    return max(sweep_bytes(cfg) / HBM_BYTES_PER_S,
               encode_flops(cfg, weighted) / BF16_FLOPS)


def rdb_bound_s(cfg: dict) -> float:
    """One dense-block launch at the frame's encoder size, by operations."""
    cam = cfg["camera"]
    return 2.0 * rdb_macs_per_px() * cam["H"] * cam["W"] / BF16_FLOPS


def train_step_flops(cfg: dict, valid: float, weighted: float) -> float:
    """One training step's operations: the rgbnet's forward and backward
    (3x the forward) on the weighted samples, the density interpolation
    (4 corners on planes, 8 in a box) forward and backward on the valid
    samples, the k0 interpolation forward and backward on the weighted
    ones."""
    fam, m = cfg["family"], cfg["model"]
    corners = C.family(fam).CORNERS
    mlp = 3 * mlp_flops(C.rgbnet_dims(fam, m)) * weighted
    grid = 2 * 2 * corners * (valid + m["rgbnet_dim"] * weighted)
    return mlp + grid
