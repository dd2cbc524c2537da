"""``blocks_ms.render``: the decoder's dense-block (or whole-RRDB)
launches, in device ms per ``frame`` span of the traced window: the
program's ``decode.blocks`` span (CUDA events at its ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "decode.blocks", "frame")
