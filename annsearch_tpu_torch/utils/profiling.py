"""Timing spans and device traces (port of ``annsearch_tpu.utils.profiling``).

The reference's observability is spans printed under ``verbose`` flags;
this module keeps the same span timers, a ``torch.profiler`` trace of the
CPU and the card written to a directory, and :func:`force`, which waits
for the device and returns a host scalar.

Host clocks time what was enqueued, not what ran: end a timed region with
:func:`force` (or ``torch.cuda.synchronize()``), or time on the card with
``torch.cuda.Event``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["Timer", "span", "device_trace", "force"]


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
