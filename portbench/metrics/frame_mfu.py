"""``frame_mfu``: the frame's operations counted from shapes (the SFTNet
at the frame's pixel counts; the rgbnet on the samples with a non-zero
weight, as the reference counts them) over the mean frame time of the
traced window, in percent of the bf16 peak."""

from portbench.metrics import _yardstick as Y


def read(rec):
    w = rec.get("counts", {}).get("weighted_per_frame")
    if w is None or "frames" not in rec:
        return None
    t = rec["window_s"] / rec["frames"]
    return 100.0 * Y.frame_flops(rec["config"], w) / t / Y.BF16_FLOPS
