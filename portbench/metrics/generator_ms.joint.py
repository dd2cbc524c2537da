"""``generator_ms.joint``: the joint step's generator forward and loss
terms, in device ms per ``sr_step`` span of the driver's span window
(spans on, no profiler): the program's ``sr.generator`` span."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "sr.generator", "sr_step")
