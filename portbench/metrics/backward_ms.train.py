"""``backward_ms.train``: the train step's autograd backward and the zero
fill of unused leaves, in device ms per ``train_step`` span of the
traced window: the program's ``train.backward`` span (CUDA events at its
ends)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_root(rec, "train.backward", "train_step")
