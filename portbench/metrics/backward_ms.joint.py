"""``backward_ms.joint``: the joint step's gradients by autograd (through
the generator into the grids) and their zero fill, in device ms per
``sr_step`` span of the driver's span window (spans on, no profiler): the
program's ``sr.backward`` span."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "sr.backward", "sr_step")
