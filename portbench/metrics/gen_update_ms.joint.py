"""``gen_update_ms.joint``: the joint step's Adam of every generator leaf,
in device ms per ``sr_step`` span of the driver's span window (spans on,
no profiler): the program's ``sr.update.generator`` span."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "sr.update.generator", "sr_step")
