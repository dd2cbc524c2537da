"""``train_mfu``: a step's operations counted from shapes and from the
samples the reference counts in the batch (``_yardstick.train_step_flops``)
over the step time of the traced window, in percent of the float32
peak (the steps run in full float32)."""

from portbench.metrics import _yardstick as Y


def read(rec):
    c = rec.get("counts", {})
    if "valid_per_step" not in c or "steps" not in rec:
        return None
    t = rec["window_s"] / rec["steps"]
    flops = Y.train_step_flops(rec["config"], c["valid_per_step"],
                               c["weighted_per_step"])
    return 100.0 * flops / t / Y.FP32_FLOPS
