"""Timing arithmetic of the benchmark: rates, percentiles, and the
reading of a ``torch.profiler`` trace (device time by kernel, busy time as
the union of the kernels' intervals, the idle gaps between them named by
what the host was doing).

The profiler rules follow the port's ``chip_smoke.profile_call``: only
device-side kernel rows count (an operator's row repeats its kernels'
time), and device time over the wall time is refused as a double count.
"""

from __future__ import annotations

import statistics
import time

MEASURED_OPS = 10  # most entries of each list of a breakdown


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    return count / seconds


def percentile(values, q: int) -> float:
    """The ``q``-th percentile (1..99) by linear interpolation between
    order statistics (``statistics.quantiles``, method ``inclusive``)."""
    vals = list(values)
    if len(vals) == 1:
        return float(vals[0])
    return statistics.quantiles(vals, n=100, method="inclusive")[q - 1]


def idle_share(busy_s: float, window_s: float) -> float:
    """Percent of the window in which no kernel ran on the device."""
    return 100.0 * (1.0 - busy_s / window_s)


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, host_events, top: int = MEASURED_OPS) -> list:
    """The ``top`` longest gaps between device intervals, each named by
    the innermost host event that spans the gap's middle (``host idle``
    where none does): ``[[name, seconds], ...]``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    longest = sorted(((b - a, 0.5 * (a + b))
                      for (_, a), (b, _) in zip(merged, merged[1:]) if b > a),
                     key=lambda g: -g[0])[:top]
    out = []
    for length, mid in longest:  # only the kept gaps are named
        spans = [(e - s, n) for s, e, n in host_events if s <= mid <= e]
        out.append([min(spans)[1] if spans else "host idle", length])
    return out


def profile(fn, sync) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and read the trace:
    ``wall_s``, ``busy_s`` (union of the device kernels' intervals),
    ``kernels`` (``[[name, total seconds, launches], ...]`` by total),
    ``gaps`` (:func:`gaps`). Returns {} when the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev_iv, host_ev, by_name = [], [], {}
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or t <= s:
                continue
            dev_iv.append((s, t))
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + (t - s), n + 1)
        else:
            host_ev.append((s, t, e.name))
    if not dev_iv:
        return {}
    busy = union_seconds(dev_iv)
    span = max(t for _, t in dev_iv) - min(s for s, _ in dev_iv)
    if busy > wall or busy > span + 1e-9:
        raise RuntimeError(f"device time {busy:.4f} s exceeds the profiled "
                           f"window {wall:.4f} s: kernel rows counted twice")
    kernels = sorted(([n, tot, c] for n, (tot, c) in by_name.items()),
                     key=lambda r: -r[1])
    return {"wall_s": wall, "busy_s": busy, "kernels": kernels,
            "gaps": gaps(dev_iv, host_ev)}


def kernel_mean_s(kernels, pattern) -> float | None:
    """Mean seconds per launch of the kernels whose name matches the
    compiled regex ``pattern``; None when none ran."""
    tot = n = 0
    for name, t, c in kernels:
        if pattern.search(name):
            tot += t
            n += c
    return tot / n if n else None
