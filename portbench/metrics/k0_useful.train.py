"""``k0_useful.train``: the share of the rows the dense training forward
computes (k0 gathered, rgbnet run: the program's ``samples.k0`` counter)
that carry a non-zero weight (``samples.weighted``), in percent, over the
traced window's steps."""

from portbench.metrics import _spans


def read(rec):
    s = _spans.summary(rec)
    if s is None:
        return None
    c = s["counters"]
    if not c.get("samples.k0") or "samples.weighted" not in c:
        return None
    return 100.0 * c["samples.weighted"] / c["samples.k0"]
