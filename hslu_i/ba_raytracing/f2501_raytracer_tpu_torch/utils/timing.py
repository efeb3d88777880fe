"""Render timing + per-tile stats (ref src/helpers.rs:110-140 `RenderTiming`
and the `render_timing_debug` chunk stats of ref renderer/mod.rs:39-78), the
program's spans, and the device busy time of a profiler trace."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType


class RenderTiming:
    """Iteration counter + elapsed/delta monotonic timing."""

    def __init__(self):
        self.iteration = 0
        self._start = time.monotonic()
        self._last = self._start
        self.elapsed = 0.0
        self.delta = 0.0

    def next(self) -> "RenderTiming":
        now = time.monotonic()
        self.iteration += 1
        self.delta = now - self._last
        self.elapsed = now - self._start
        self._last = now
        return self

    def __repr__(self):
        return (
            f"RenderTiming(iteration={self.iteration}, "
            f"elapsed={self.elapsed:.3f}s, delta={self.delta:.3f}s)"
        )


class TileStats:
    """Mean/median/std/min/max of per-tile render seconds."""

    def __init__(self):
        self.times: List[float] = []

    def push(self, seconds: float):
        self.times.append(seconds)

    def summary(self) -> dict:
        if not self.times:
            return {}
        xs = sorted(self.times)
        n = len(xs)
        mean = sum(xs) / n
        median = xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2
        var = sum((x - mean) ** 2 for x in xs) / max(n - 1, 1)
        return dict(mean=mean, median=median, std=var**0.5, min=xs[0], max=xs[-1], count=n)

    def print(self):
        s = self.summary()
        if not s:
            return
        print("Render time per Chunk:")
        for k in ("mean", "median", "std", "min", "max"):
            print(f"{k.capitalize()}: {s[k]}")


# ---- program spans --------------------------------------------------------
#
# Spans at the boundaries of the renderer (renderer.py::render_u32) and of
# the pool loop (ops/trace.py), kept in memory until `take_spans` hands them
# over; nothing is written out. Whether a frame records is decided once, at
# `render_u32`'s entry (`frame_recording`): while a torch profiler records.
# `span` tests that one boolean (`ON`) and, when it is false, returns an inert
# span, so a frame that does not record pays a test and a call per site and
# nothing on the device. Timestamps are `time.time_ns()`, Unix-epoch
# nanoseconds: the clock of the profiler's events (`kineto_results.events()`),
# so spans and device operations lie on one timeline.

ON = False  # whether spans record: set at a frame's entry, cleared at its end

_lock = threading.Lock()
_spans: List["Span"] = []
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open spans
_frame: Optional[int] = None  # the open frame span's id


@dataclasses.dataclass
class Span:
    """One timed range of the program: `start` and `end` in Unix-epoch ns,
    the id of the span that encloses it (on its own thread, else the frame
    it belongs to), the id of its frame, and integer counters, which the
    code may add to after the span has closed."""

    name: str
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    id: int = 0
    parent: Optional[int] = None
    frame: Optional[int] = None
    start: int = 0
    end: int = 0

    def __enter__(self) -> "Span":
        global _frame
        self.id = next(_ids)
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else _frame
        if self.name == "frame":
            _frame = self.id
        self.frame = _frame
        stack.append(self)
        with _lock:
            _spans.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _frame, ON
        self.end = time.time_ns()
        _local.stack.pop()
        if self.name == "frame":  # a frame's decision ends with it
            _frame = None
            ON = False


class _Inert:
    """What `span` returns while spans do not record: entering and leaving do
    nothing, and counters set on it are thrown away."""

    counters: Dict[str, int] = {}

    def __enter__(self) -> "_Inert":
        return self

    def __exit__(self, *exc) -> None:
        pass


_INERT = _Inert()


def span(name: str, **counters: int):
    """A span named `name` with `counters`, to enter with `with`: recorded
    while `ON`, else an inert one."""
    return Span(name, counters) if ON else _INERT


def frame_recording() -> None:
    """Decides, at a frame's entry, whether its spans are recorded: while a
    torch profiler records. Sets `ON`."""
    global ON
    ON = torch._C._autograd._profiler_enabled()


def take_spans() -> List[Span]:
    """The spans recorded so far, in the order they opened; clears them."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def device_busy_ms(events) -> float:
    """Device busy time of a torch.profiler trace, in ms: the union of the
    intervals of its device events (`prof.events()`: kernels, copies and
    memsets, `time_range` in us). An operator's own device time also holds
    its kernels', so a sum over `key_averages()` counts a kernel twice."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)):
        a = max(a, reach)
        if b > a:
            total, reach = total + b - a, b
    return total / 1e3
