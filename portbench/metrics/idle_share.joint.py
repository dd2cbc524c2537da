"""``idle_share.joint``: percent of a profiled run of joint steps in which
no kernel ran on the device (``torch.profiler``)."""

from portbench import timing


def read(rec):
    p = rec.get("profile")
    if not p or "steps" not in rec:
        return None
    return timing.idle_share(p["busy_s"], p["wall_s"])
