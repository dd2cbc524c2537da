"""``joint_mfu``: a joint step's operations counted from shapes and from
the samples the reference counts in the patch
(``_joint_yardstick.joint_step_flops``) over the step time of the traced
window, in percent of the float32 peak (the decoder runs in full
float32)."""

from portbench.metrics import _joint_yardstick as J
from portbench.metrics import _yardstick as Y


def read(rec):
    c = rec.get("counts", {})
    if "weighted_per_step" not in c or "steps" not in rec \
            or "N_patch" not in rec["config"]["train"]:
        return None
    t = rec["window_s"] / rec["steps"]
    flops = J.joint_step_flops(rec["config"], c["weighted_per_step"])
    return 100.0 * flops / t / Y.FP32_FLOPS
