"""``tail_ms.render``: the decoder's upsample tail (``conv_up2``,
``conv_hr``, ``conv_last``), in device ms per ``frame`` span of the
traced window: the program's ``decode.tail`` span (CUDA events at its
ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "decode.tail", "frame")
