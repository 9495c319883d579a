"""A profiler timeline of a stretch of the window, and what the metric
readers take from it.

``torch.profiler`` records the card's kernels, copies and memsets and the
host's operations; the timeline is written as a Chrome trace under the
temporary directory (``TMPDIR``), read back and deleted. The stretch is
marked by a ``portbench.window`` annotation, and only device operations
inside it count.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

import torch

from . import stats

__all__ = ["Timeline", "Tracer", "read_chrome_trace", "short_name", "per_call_s",
           "WINDOW_MARK", "K1", "K2"]

WINDOW_MARK = "portbench.window"
#: K1's kernels by the names the build gives them (``csrc/ivf_scan.cu``):
#: the fused cell scan and the wide rows' query terms
K1 = ("ivf_scan_kernel", "query_terms_kernel")
#: K2's kernels (``csrc/flat_scan.cu``): the scans, the extraction, the merge
K2 = ("flat_scan_kernel", "flat_scan_wide_kernel", "flat_extract_kernel", "flat_merge_kernel")
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}
#: host operations looked back through to label one idle gap
_LABEL_LOOKBACK = 4_000


def short_name(name: str) -> str:
    """A device operation's name without ``void``, an anonymous namespace
    and its argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out).strip()[:160]


class Timeline:
    """Device operations ``(name, start, end)`` in µs inside the window
    ``[lo, hi]``, and the host operations around them."""

    def __init__(self, device_ops, host_ops, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.device_ops = [(n, max(a, lo), min(b, hi)) for n, a, b in device_ops
                           if b > lo and a < hi]
        self.host_ops = sorted(host_ops, key=lambda o: o[1])
        self._starts = [o[1] for o in self.host_ops]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return stats.union_length([(a, b) for _, a, b in self.device_ops], self.lo,
                                  self.hi) * 1e-6

    def device_s(self, match=None) -> float:
        """Summed seconds of the device operations whose short name
        ``match`` accepts (all of them without ``match``)."""
        return sum(b - a for n, a, b in self.device_ops
                   if match is None or match(short_name(n))) * 1e-6

    def host_label(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self._starts, t)
        for j in range(i - 1, max(i - 1 - _LABEL_LOOKBACK, -1), -1):
            name, a, b = self.host_ops[j]
            if a <= t <= b:
                return name
        return "host: no recorded operation"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        time by what the host was doing, ``[[name, seconds], ...]`` each."""
        ops = stats.top_by_total(((short_name(nm), (b - a) * 1e-6)
                                  for nm, a, b in self.device_ops), n)
        gaps = stats.idle_gaps([(a, b) for _, a, b in self.device_ops], self.lo, self.hi)
        idle = stats.top_by_total(((self.host_label((a + b) / 2), (b - a) * 1e-6)
                                   for a, b in gaps), n)
        return {"device_ops": ops, "idle_gaps": idle}


def read_chrome_trace(events: list[dict]) -> Timeline:
    """The timeline of a Chrome trace's events (``traceEvents``)."""
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in _DEVICE_CATS:
            device.append((e.get("name", "?"), a, b))
        elif cat in _HOST_CATS:
            if cat == "user_annotation" and e.get("name") == WINDOW_MARK:
                window = (a, b)
            else:
                host.append((e.get("name", "?"), a, b))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_MARK!r} annotation")
    return Timeline(device, host, *window)


class Tracer:
    """A profiler over a stretch of calls: ``start()`` turns it on,
    ``open_window()`` begins the stretch that counts (so the profiler's own
    start-up falls outside it), ``stop()`` ends both and leaves the
    stretch's :class:`Timeline` in ``timeline``."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._open = False
        self.timeline: Timeline | None = None

    def start(self) -> None:
        self._prof.start()

    def open_window(self) -> None:
        self._mark.__enter__()
        self._open = True

    def stop(self) -> None:
        """Stop; read the timeline where the stretch was opened."""
        if self._open:
            self._mark.__exit__(None, None, None)
        self._prof.stop()
        if not self._open:
            return
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.timeline = read_chrome_trace(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)


def per_call_s(ctx, prefixes: tuple[str, ...] | None = None, exclude: bool = False):
    """Device seconds per traced call of the operations whose short name
    starts with one of ``prefixes`` (of all the others with ``exclude``;
    of every operation without ``prefixes``), or None where the run has no
    timeline."""
    if ctx.timeline is None or not ctx.traced_calls:
        return None
    match = None if prefixes is None else (
        lambda name: name.startswith(prefixes) != exclude)
    return ctx.timeline.device_s(match) / len(ctx.traced_calls)
