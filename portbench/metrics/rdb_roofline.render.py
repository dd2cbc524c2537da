"""``rdb_roofline.render``: one dense-block launch's operations (249,856
MAC a pixel at the encoder's size) at the bf16 peak, over the kernel's
mean device time in the profiled frames, in percent."""

import re

from portbench import timing
from portbench.metrics import _yardstick as Y

KERNEL = re.compile(r"\brdb_kernel\b")


def read(rec):
    p = rec.get("profile")
    if not p or "frames" not in rec:
        return None
    t = timing.kernel_mean_s(p["kernels"], KERNEL)
    if t is None:
        return None
    return 100.0 * Y.rdb_bound_s(rec["config"]) / t
