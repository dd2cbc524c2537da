"""Spans and counters of the program, on the profiler's clock.

A :class:`span` marks one phase of the work (a frame's encode, a train
step's backward). While tracing is on, each pass through it enters a
``torch.profiler.record_function`` range of its name (a host event in a
profiler trace, beside the kernels it launched), stamps the host clock at
its start and end, records a CUDA event pair on the current stream (when
CUDA is in use) and keeps one record: name, span id, parent span id, root
id, host interval, device interval. A root span (``frame``, ``train_step``,
``sr_step``) opens a new root id, which every span under it carries; a
span with no open span around it is a root too. :func:`count` adds to a
named counter; a device tensor adds on the device, read only by
:func:`summary`.

Tracing is on while a ``torch.profiler`` session records, or after
:func:`enable`. Off, entering a span is one check and nothing else: no
range, no event, no allocation, no record. Callers guard the values they
would pass to :func:`count` with :func:`on`.

Records live in memory, at most :data:`LIMIT` of them; later ones are
dropped and counted. CUDA events come from a pool per device, refilled
from the records whose events the device has passed, so recording neither
allocates once the pool has grown to the queue's depth nor synchronizes.
:func:`summary` synchronizes once and reads them all. The state is the
process's and is meant for the thread that runs the work.
"""

from __future__ import annotations

import collections
import functools
import time

import torch

LIMIT = 65_536  # records kept; spans past it are dropped and counted

_profiling = torch._C._autograd._profiler_enabled

_forced = False
_records: list = []
_stack: list = []                # open spans: (span, id, root, range, record)
_pending = collections.deque()   # closed records whose events are unread
_pool: dict = {}                 # device index -> free CUDA events
_counters: dict = {}
_dropped = 0
_next_id = 0


def enable() -> None:
    """Record spans and counters with no profiler running."""
    global _forced
    _forced = True


def disable() -> None:
    """Record only while a profiler session records."""
    global _forced
    _forced = False


def on() -> bool:
    """Whether spans and counters record now."""
    return _forced or _profiling()


class _Record:
    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "ms", "dev",
                 "ev0", "ev1")

    def __init__(self, name, sid, parent, root):
        self.name, self.id, self.parent, self.root = name, sid, parent, root
        self.t0 = self.t1 = 0
        self.ms = self.dev = self.ev0 = self.ev1 = None


class span:
    """A named phase: a context manager, or a decorator of a function that
    runs inside it. ``root`` opens a new root id. The object keeps no state
    of a pass, so one module-level span serves every call."""

    __slots__ = ("name", "root")

    def __init__(self, name: str, *, root: bool = False):
        self.name, self.root = name, root

    def __enter__(self):
        if _forced or _profiling():
            _open(self)
        return self

    def __exit__(self, *exc):
        if _stack and _stack[-1][0] is self:
            _close()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return traced


def take_event() -> torch.cuda.Event:
    """A timing CUDA event of the current device: from the pool, else a
    new one."""
    free = _pool.setdefault(torch.cuda.current_device(), [])
    if not free:
        _harvest()
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _open(sp: span) -> None:
    global _next_id, _dropped
    _next_id += 1
    sid = _next_id
    parent, root = (_stack[-1][1], _stack[-1][2]) if _stack else (None, sid)
    if sp.root:
        root = sid
    rf = torch.profiler.record_function(sp.name)
    rf.__enter__()
    rec = None
    if len(_records) < LIMIT:
        rec = _Record(sp.name, sid, parent, root)
        if torch.cuda.is_initialized():
            rec.dev = torch.cuda.current_device()
            rec.ev0 = take_event()
            rec.ev0.record()
        _records.append(rec)
    else:
        _dropped += 1
    _stack.append((sp, sid, root, rf, rec))
    if rec is not None:
        rec.t0 = time.perf_counter_ns()


def _close() -> None:
    _, _, _, rf, rec = _stack.pop()
    if rec is not None:
        rec.t1 = time.perf_counter_ns()
        if rec.ev0 is not None:
            rec.ev1 = take_event()
            rec.ev1.record()
            _pending.append(rec)
    rf.__exit__(None, None, None)


def _harvest() -> None:
    """Read the events of the oldest closed records that the device has
    passed, in order, and return the events to their pools."""
    while _pending:
        r = _pending[0]
        if not (r.ev1.query() and r.ev0.query()):
            return
        r.ms = r.ev0.elapsed_time(r.ev1)
        _pool.setdefault(r.dev, []).extend((r.ev0, r.ev1))
        r.ev0 = r.ev1 = None
        _pending.popleft()


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d device tensor, summed on the
    device) to the counter ``name``."""
    if _forced or _profiling():
        _counters[name] = _counters.get(name, 0) + value


def summary() -> dict:
    """The closed records and the counters, the device synchronized once:
    ``spans`` (per name: ``count``, ``device_ms``, ``host_ms``,
    ``self_device_ms``, ``self_host_ms``; a self time is the span's less
    its child spans'; device times are None where a record has no events),
    ``roots`` (the count of each root name), ``counters`` (totals as
    Python numbers) and ``dropped`` (records past :data:`LIMIT`)."""
    for dev in {r.dev for r in _pending}:
        torch.cuda.synchronize(dev)
    _harvest()
    done = [r for r in _records if r.t1]
    kids: dict = {}
    for r in done:
        if r.parent is not None:
            ms, ns = kids.get(r.parent, (0.0, 0))
            kids[r.parent] = (None if ms is None or r.ms is None
                              else ms + r.ms, ns + r.t1 - r.t0)
    spans, roots = {}, {}
    for r in done:
        s = spans.setdefault(r.name, {"count": 0, "device_ms": 0.0,
                                      "host_ms": 0.0, "self_device_ms": 0.0,
                                      "self_host_ms": 0.0})
        k_ms, k_ns = kids.get(r.id, (0.0, 0))
        host = (r.t1 - r.t0) * 1e-6
        s["count"] += 1
        s["host_ms"] += host
        s["self_host_ms"] += host - k_ns * 1e-6
        if r.ms is None or k_ms is None or s["device_ms"] is None:
            s["device_ms"] = s["self_device_ms"] = None
        else:
            s["device_ms"] += r.ms
            s["self_device_ms"] += r.ms - k_ms
        if r.id == r.root:
            roots[r.name] = roots.get(r.name, 0) + 1
    counters = {k: v.item() if isinstance(v, torch.Tensor) else v
                for k, v in _counters.items()}
    return {"spans": spans, "roots": roots, "counters": counters,
            "dropped": _dropped}


def reset() -> None:
    """Forget the records, the counters and the dropped count (a span open
    across the reset is left out)."""
    global _dropped
    _records.clear()
    _pending.clear()
    _counters.clear()
    _dropped = 0
