"""``tv_ms.train``: the train step's TV gradients, in device ms per
``train_step`` span of the traced window: the program's ``train.tv``
span (CUDA events at its ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "train.tv", "train_step")
