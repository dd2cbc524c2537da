"""``sweep_roofline.render``: the plane sweep's least time (bytes of its
live grid channels and rays at the HBM rate, or its bf16 MLP on the
weighted samples at the bf16 peak) over the kernel's mean device time in
the profiled frames, in percent."""

import re

from portbench import timing
from portbench.metrics import _yardstick as Y

KERNEL = re.compile(r"\bsweep_kernel\b")


def read(rec):
    p, w = rec.get("profile"), rec.get("counts", {}).get("weighted_per_frame")
    if not p or w is None:
        return None
    t = timing.kernel_mean_s(p["kernels"], KERNEL)
    if t is None:
        return None
    return 100.0 * Y.sweep_bound_s(rec["config"], w) / t
