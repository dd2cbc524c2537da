"""The least work of a joint step, counted from shapes: the decoder's
convolutions forward and backward at the patch's size, and the rgbnet
forward and backward on the samples with a non-zero weight."""

from __future__ import annotations

from portbench.metrics import _yardstick as Y
from portbench.reference import common as C


def sftnet_train_flops(dec: dict, h: int, w: int) -> int:
    """FLOPs of the SFTNet's convolutions on an ``h x w`` patch, forward
    and backward: each conv's forward, its weight gradient and its input
    gradient (each as many as the forward), but ``cond0``'s input
    gradient, which the detached depth condition does not take."""
    fwd = 2 * Y.frame_decode_macs(dec, h, w)
    cond0 = 2 * 9 * dec["num_cond"] * 64 * h * w
    return 3 * fwd - cond0


def joint_step_flops(cfg: dict, weighted: float) -> float:
    """One joint step: the decoder at the patch's size and the rgbnet's
    forward and backward (3x its forward) on ``weighted`` samples."""
    p = cfg["train"]["N_patch"]
    mlp = 3 * Y.mlp_flops(C.rgbnet_dims(cfg["family"], cfg["model"]))
    return sftnet_train_flops(cfg["decoder"], p, p) + mlp * weighted
