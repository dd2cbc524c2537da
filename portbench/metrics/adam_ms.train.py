"""``adam_ms.train``: the train step's MaskedAdam, in device ms per
``train_step`` span of the traced window: the program's ``train.adam``
span (CUDA events at its ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "train.adam", "train_step")
