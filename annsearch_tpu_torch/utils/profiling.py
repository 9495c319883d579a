"""Timing spans and device traces (port of ``annsearch_tpu.utils.profiling``),
and the program's own stage spans.

The reference's observability is spans printed under ``verbose`` flags;
this module keeps the same span timers, a ``torch.profiler`` trace of the
CPU and the card written to a directory, and :func:`force`, which waits
for the device and returns a host scalar.

Host clocks time what was enqueued, not what ran: end a timed region with
:func:`force` (or ``torch.cuda.synchronize()``), or time on the card with
``torch.cuda.Event``.

The query paths open a :func:`stage` at each layer boundary (``ivf.query``,
``ivf.route``, ``ivf.lists``, ``ivf.host_lists``, ``ivf.scan``,
``ivf.cluster_scan``, ``ivf.merge``, ``topk.exact``, ``topk.certified``). A stage does nothing
but test one flag unless tracing is on (:func:`enable`) or a
``torch.profiler`` is recording:

* while a profiler records, the stage enters
  ``torch.profiler.record_function(name)``, so the trace shows it as a
  ``user_annotation`` on the kernels' clock;
* while tracing is on, it records its host interval
  (``time.perf_counter_ns``), on a CUDA tensor's device a pair of timing
  events on the current stream (the device interval: from the stream
  reaching the stage to its last operation finishing, idle time
  included), its parent stage, the id of the outermost stage's call, and
  its counts. :func:`snapshot` returns the aggregates by name.

Events are resolved once the stream has passed them (at the next outermost
stage or at :func:`snapshot`), never by a synchronise, and go back to a
pool. Counts are host integers the caller has at hand; the arithmetic of
one runs only where the stage is true (tracing on), and none reads the
device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Timer", "span", "device_trace", "force", "enable", "disable", "reset", "stage",
           "snapshot"]


class Timer:
    """Accumulating named spans: ``with timer.span("assign"): ...``."""

    def __init__(self, verbose: bool = False):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.verbose = verbose

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self.verbose:
                print(f"  [{name}] {dt * 1000:.1f} ms")

    def report(self) -> str:
        return "\n".join(
            f"{name:<30} {self.totals[name] * 1000:>10.1f} ms ({self.counts[name]}x)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        )


@contextlib.contextmanager
def span(name: str, verbose: bool = True):
    """One-off span printed when verbose."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            print(f"[{name}] {(time.perf_counter() - t0) * 1000:.1f} ms")


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there is
    a card), written on exit as a Chrome trace into ``logdir``. Yields the
    profiler, whose ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def force(x) -> float:
    """Wait for ``x`` (a tensor, or anything numpy reads) and return its
    first element as a host float (0.0 when empty): a timing barrier. A
    CUDA tensor is waited for by ``torch.cuda.synchronize()``."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.reshape(-1)[0]) if x.numel() else 0.0
    import numpy as np

    arr = np.asarray(x)
    return float(arr.reshape(-1)[0]) if arr.size else 0.0


# -- the program's stage spans -------------------------------------------------


class _Recorder:
    """Tracing state: the switch, the open stages, the closed ones whose
    events are not resolved yet, the aggregates by name and the event
    pool."""

    def __init__(self):
        self.on = False
        self.calls = 0
        self.open: list[_Stage] = []
        self.pending: deque[_Stage] = deque()
        self.stats: dict[str, dict] = {}
        self.events: list = []

    def event(self):
        return self.events.pop() if self.events else torch.cuda.Event(enable_timing=True)

    def resolve(self) -> None:
        """Fold in the device intervals of closed stages whose end event
        the stream has passed, in the order they closed (a child before its
        parent), without waiting."""
        while self.pending and self.pending[0].ev1.query():
            s = self.pending.popleft()
            ns = round(s.ev0.elapsed_time(s.ev1) * 1e6)
            st = self.stats.get(s.name)
            if st is not None:
                st["device_ns"] = (st["device_ns"] or 0) + ns
                st["device_self_ns"] = (st["device_self_ns"] or 0) + ns - s.child_device_ns
            if s.parent is not None:
                s.parent.child_device_ns += ns
            self.events += (s.ev0, s.ev1)
            s.ev0 = s.ev1 = None


_rec = _Recorder()


def enable() -> None:
    """Turn tracing on: every stage from now on records its intervals and
    counts."""
    _rec.on = True


def disable() -> None:
    """Turn tracing off (the aggregates stay until :func:`reset`)."""
    _rec.on = False


def reset() -> None:
    """Drop the aggregates and the stages not resolved yet."""
    _rec.resolve()
    _rec.pending.clear()
    _rec.stats.clear()


def snapshot() -> dict[str, dict]:
    """The aggregates by stage name, each a dict of ``calls``, ``host_ns``
    and ``host_self_ns`` (the host interval, and it less the part its child
    stages cover), ``device_ns`` and ``device_self_ns`` (the same of the
    device interval; None where no stage of the name ran on a CUDA tensor
    or its events are not passed yet), ``counts`` (summed), and of the
    latest stage of the name its ``parent`` name (None if outermost) and
    ``call``, the id its outermost stage's call took. Resolves what the
    device has finished first; never synchronises."""
    _rec.resolve()
    return {name: dict(st, counts=dict(st["counts"])) for name, st in _rec.stats.items()}


class _Off:
    """The stage of a disabled recorder: false, and does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, **counts) -> None:
        return None


_OFF = _Off()


def _stream(dev):
    """The current stream of a CUDA tensor's or device's card, else None."""
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    if dev is None or torch.device(dev).type != "cuda":
        return None
    return torch.cuda.current_stream(dev)


class _Stage:
    __slots__ = ("name", "stream", "counts", "tracing", "annotation", "parent", "call",
                 "t0", "ev0", "ev1", "child_host_ns", "child_device_ns")

    def __init__(self, name: str, dev):
        self.name, self.counts, self.tracing = name, {}, _rec.on
        self.annotation = (torch.profiler.record_function(name)
                           if _autograd_profiler._is_profiler_enabled else None)
        self.stream = _stream(dev) if self.tracing else None
        self.ev0 = self.ev1 = None

    def __bool__(self) -> bool:
        return self.tracing

    def count(self, **counts) -> None:
        """Add ``counts`` to the stage's own (only while tracing)."""
        if self.tracing:
            for k, v in counts.items():
                self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        if self.tracing:
            self.parent = _rec.open[-1] if _rec.open else None
            if self.parent is None:
                _rec.resolve()
                _rec.calls += 1
            self.call = _rec.calls if self.parent is None else self.parent.call
            self.child_host_ns = self.child_device_ns = 0
            _rec.open.append(self)
            if self.stream is not None:
                self.ev0 = _rec.event()
                self.ev0.record(self.stream)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.tracing:
            host = time.perf_counter_ns() - self.t0
            if self.stream is not None:
                self.ev1 = _rec.event()
                self.ev1.record(self.stream)
                _rec.pending.append(self)
            _rec.open.pop()
            if self.parent is not None:
                self.parent.child_host_ns += host
            st = _rec.stats.get(self.name)
            if st is None:
                st = _rec.stats[self.name] = {
                    "calls": 0, "host_ns": 0, "host_self_ns": 0, "device_ns": None,
                    "device_self_ns": None, "counts": {}, "parent": None, "call": None}
            st["calls"] += 1
            st["host_ns"] += host
            st["host_self_ns"] += host - self.child_host_ns
            for k, v in self.counts.items():
                st["counts"][k] = st["counts"].get(k, 0) + v
            st["parent"] = None if self.parent is None else self.parent.name
            st["call"] = self.call
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def stage(name: str, dev=None):
    """A stage of the program: ``with stage("ivf.scan", q) as st: ...``.
    ``dev`` is a tensor (or device) whose card's current stream the device
    interval is timed on. The stage is true while tracing, and takes its
    counts (host integers) by ``st.count(...)``, under ``if st:`` where
    they take arithmetic. With tracing off and no profiler recording it
    returns a shared no-op at the cost of one flag test."""
    if not (_rec.on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Stage(name, dev)
