"""The timed window and the traced frames.

Closed loop, one client: a frame starts when the previous one has returned
its pixels to the host. The window starts with the first timed frame and
ends with the last frame that completes, the one that crosses `seconds`
included. A frame's wall is the host clock around the renderer's call,
fetch included; between frames the harness only compares the frame's bits
with the run's first frame (a frame that dropped rays, left rays untraced or
changed its bits counts as failed) and keeps one frame, drawn from the seed,
for the comparison with the reference.
"""

from __future__ import annotations

import time

import numpy as np


class Frames:
    """The frames of a window: walls, failures, one sampled frame."""

    def __init__(self, first: np.ndarray, rng: np.random.Generator):
        self.first, self.rng = first, rng
        self.walls, self.failed, self.sample = [], 0, None
        self.bad = []  # (frame index, dropped, unfinished, same bits) of failures

    def add(self, px, dropped, unfinished, wall):
        same = np.array_equal(px, self.first)
        if dropped or unfinished or not same:
            self.failed += 1
            if len(self.bad) < 5:
                self.bad.append((len(self.walls), int(dropped), int(unfinished), bool(same)))
        self.walls.append(wall)
        if self.rng.integers(len(self.walls)) == 0:  # a uniform draw, one frame kept
            self.sample = px


def timed(frame, frames: Frames, seconds: float) -> float:
    """Run frames back to back for `seconds`; returns the window's length."""
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        px, dropped, unfinished = frame()
        t1 = time.perf_counter()
        frames.add(px, dropped, unfinished, t1 - t0)
        if t1 - t_start >= seconds:
            return time.perf_counter() - t_start


def traced(frame, frames: Frames, min_seconds: float, profile_ctx, mark_ctx):
    """Whole frames under the profiler until `min_seconds` have passed (one
    at least); returns the host wall of the traced window."""
    with profile_ctx:
        with mark_ctx:
            t_start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                px, dropped, unfinished = frame()
                t1 = time.perf_counter()
                frames.add(px, dropped, unfinished, t1 - t0)
                if t1 - t_start >= min_seconds:
                    break
            wall = time.perf_counter() - t_start
    return wall
