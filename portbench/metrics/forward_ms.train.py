"""``forward_ms.train``: the train step's forward and losses, in device ms
per ``train_step`` span of the traced window: the program's
``train.forward`` span (CUDA events at its ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "train.forward", "train_step")
