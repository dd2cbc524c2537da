"""``render_ms.joint``: the joint step's patch render by the encoder, in
device ms per ``sr_step`` span of the driver's span window (spans on, no
profiler): the program's ``sr.render`` span (CUDA events at its ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "sr.render", "sr_step")
