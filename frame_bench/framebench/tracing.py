"""Traced frames: the profiler's events, kept in memory, and the arithmetic
the per-layer metrics read from them.

The arithmetic is pure functions over `Event`s, tested on synthetic lists:
* device busy time is the union of the intervals of device operations
  (kernels, copies, memsets) inside the traced window; an `aten::` operator
  is a host event and never adds device time, so a kernel is counted once,
  however many host ranges enclose its launch;
* launches are the host's runtime calls that put work on the device
  (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaLaunchKernelExC`,
  `cuLaunchKernelEx`, `cudaGraphLaunch`): a graph replay is one launch;
* idle gaps are the stretches of the window in which no device operation
  ran, named by the innermost host event that spans the gap's middle.
On the card only the CUDA activity is traced (the kernels, copies and the
runtime calls): tracing every `aten::` operator as well stretched a
`realistic` frame from ~5 s to 7.8-8.6 s, against 6.7-6.9 s without them.
No chrome trace is written: a `realistic` frame is some 290,000 launches.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernelEx", "cudaGraphLaunch"})
DEVICE_KINDS = ("kernel", "memcpy", "memset")
WINDOW_MARK = "frame_bench.traced_window"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str  # kernel | memcpy | memset | runtime | cpu | mark
    start: float  # seconds, the profiler's clock
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


def _kind(activity: str, name: str, on_device: bool) -> str:
    a = activity.lower()
    if "user_annotation" in a or name == WINDOW_MARK:
        return "gpu_mark" if on_device or a.startswith("gpu") else "mark"
    if "memcpy" in a or (on_device and name.startswith("Memcpy")):
        return "memcpy"
    if "memset" in a or (on_device and name.startswith("Memset")):
        return "memset"
    if "kernel" in a or on_device:
        return "kernel"
    if "runtime" in a or "driver" in a or (not a and name.startswith("cu")):
        return "runtime"
    return "cpu"


def events_from_profile(prof) -> list:
    """The profiler's events, read from its results in memory."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        on_dev = e.device_type() == DeviceType.CUDA
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append(Event(name, _kind(act, name, on_dev), start, dur))
    return out


def window_of(events) -> tuple:
    """(start, end) of the traced window's mark where the host's ranges were
    traced, else the span of the device operations and runtime calls."""
    marks = [e for e in events if e.kind == "mark" and e.name == WINDOW_MARK]
    if marks:
        return marks[0].start, marks[0].end
    span = [e for e in events if e.kind in DEVICE_KINDS or e.kind == "runtime"] or events
    return min(e.start for e in span), max(e.end for e in span)


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union_intervals(intervals) -> list:
    """Merged, sorted (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def device_intervals(events, window) -> list:
    return union_intervals(_clip([(e.start, e.end) for e in events if e.kind in DEVICE_KINDS],
                                 *window))


def busy_seconds(events, window) -> float:
    return sum(b - a for a, b in device_intervals(events, window))


def launch_count(events) -> int:
    """Host runtime calls that launch device work; a suffix such as `_ptsz`
    or `_v7000` names the same call."""
    return sum(1 for e in events if e.kind == "runtime" and e.name.split("_")[0] in LAUNCH_CALLS)


def device_seconds_by_name(events, window) -> dict:
    out = defaultdict(float)
    lo, hi = window
    for e in events:
        if e.kind in DEVICE_KINDS and e.end > lo and e.start < hi:
            out[e.name] += min(e.end, hi) - max(e.start, lo)
    return dict(out)


def top(items: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, window) -> dict:
    """{what the host was doing: idle seconds} over the window's gaps, each
    gap named by the innermost host event open at its middle (one sweep;
    host events nest), else `host, between operations`."""
    lo, hi = window
    gaps, t = [], lo
    for a, b in device_intervals(events, window):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = sorted((e for e in events if e.kind in ("cpu", "runtime")), key=lambda e: e.start)
    out = defaultdict(float)
    open_, k = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(host) and host[k].start <= mid:
            while open_ and open_[-1].end < host[k].start:
                open_.pop()
            open_.append(host[k])
            k += 1
        while open_ and open_[-1].end < mid:
            open_.pop()
        out[open_[-1].name if open_ else "host, between operations"] += b - a
    return dict(out)
