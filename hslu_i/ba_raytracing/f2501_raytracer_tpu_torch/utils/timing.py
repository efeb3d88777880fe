"""Render timing + per-tile stats (ref src/helpers.rs:110-140 `RenderTiming`
and the `render_timing_debug` chunk stats of ref renderer/mod.rs:39-78)."""

from __future__ import annotations

import time
from typing import List


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
