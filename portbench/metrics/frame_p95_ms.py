"""``frame_p95_ms``: the 95th percentile of every frame's latency in the
window (pose handed in to the decoded frame synced; host clock)."""

from portbench import timing


def read(rec):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    return 1e3 * timing.percentile(lat, 95)
