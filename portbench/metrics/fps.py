"""``fps``: frames completed in the window over the window's seconds
(host clock; each frame ends at ``torch.cuda.synchronize()`` after its
decode)."""

from portbench import timing


def read(rec):
    if "frames" not in rec:
        return None
    return timing.rate(rec["frames"], rec["window_s"])
