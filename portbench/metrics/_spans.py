"""Readings of the program's own spans and counters
(``fourk_nerf_torch.utils.trace``). They record while a profiler session
records, which in a run is the traced window (``rec["profile"]``); a
program without the module, or a run without that window, reads
nothing."""


def summary(rec):
    """The program's ``trace.summary()`` after a traced window, else
    None."""
    if "profile" not in rec:
        return None
    try:
        from fourk_nerf_torch.utils import trace
    except ImportError:
        return None
    return trace.summary()


def ms_per_root(rec, span: str, root: str):
    """Device ms of ``span`` over the count of ``root`` spans (frames or
    steps), or None where either is absent."""
    s = summary(rec)
    if s is None:
        return None
    n, sp = s["roots"].get(root), s["spans"].get(span)
    if not n or sp is None or sp["device_ms"] is None:
        return None
    return sp["device_ms"] / n
