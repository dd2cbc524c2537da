"""``enc_update_ms.joint``: the joint step's MaskedAdam of the encoder
(the grid window's on the window path), in device ms per ``sr_step`` span
of the driver's span window (spans on, no profiler): the program's
``sr.update.encoder`` span."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "sr.update.encoder", "sr_step")
