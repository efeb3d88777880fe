"""PyTorch port: the program's spans (`utils/timing.py`), on the CPU.

A u32 frame records its spans while a torch profiler records, and nothing
otherwise; recording leaves the frame's bits as they are. One frame's spans
form one tree: `frame`, and inside it `frame.plan`, a `tile` per tile,
`frame.fetch` and `frame.reorder`; inside a tile each pool chunk
(`pool.chunk`) and each read of the pool's count (`pool.sync`). `live_iters`
counts the iterations of a chunk that found the pool non-empty. The spans
are stamped on the clock of the profiler's events. Beside them: the
benchmark's self time of a span (`frame_bench/framebench/spans.py`) and the
device busy time of a profiler trace as the union of its device events'
intervals.
"""

from __future__ import annotations

import os
import sys
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "frame_bench"))
from framebench import spans as fb_spans  # noqa: E402

# test_torch_unfinished.py's frame in two tiles of 144 rays: the pool at W = 64
CFG = dict(width=24, height=12, reflections=True, refractions=True, kernel_ray_tile=64,
           compaction_ratio=2, tile_rays=144, device_encode=True)


@pytest.fixture(scope="module")
def scene():
    cfg = RenderConfig(**CFG)
    return RaytracerRenderer(cfg, device="cpu").device_scene(build("semesterbild", cfg))


def _profiled():
    """A CPU profile: a frame rendered inside records its spans."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _recorded_frame(scene, **kw):
    """(pixels, spans) of one frame rendered under a profile."""
    r = RaytracerRenderer(RenderConfig(**CFG, **kw), device="cpu")
    timing.take_spans()
    with _profiled():
        px = r.render_u32(scene)
    assert r.last_unfinished == 0 and r.last_dropped == 0
    return px, timing.take_spans()


# the SIMD build's frame: host_read stacks the packet check, then `live_iters`
FRAMES = {"rows": dict(CFG, loop_chunk=2),
          "packet": dict(width=16, height=12, reflections=True, refractions=True,
                         device_encode=True, anti_aliasing_rotation_scale=True,
                         anti_aliasing_randomness=True, packet_mode=True, aa_packet_lanes=8,
                         kernel_ray_tile=64, compaction_ratio=4, loop_chunk=8, max_nodes=24)}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_recording_keeps_the_bits_and_off_records_nothing(frame):
    cfg = RenderConfig(**FRAMES[frame])
    r = RaytracerRenderer(cfg, device="cpu")
    scene = r.device_scene(build("semesterbild", cfg))
    timing.take_spans()
    off = r.render_u32(scene)
    assert timing.take_spans() == [] and not timing.ON
    with _profiled():
        on = r.render_u32(scene)
    rec = timing.take_spans()
    assert np.array_equal(on, off) and r.last_unfinished == 0
    assert any(s.name == "pool.chunk" and s.counters["live_iters"] > 0 for s in rec)
    assert not timing.ON


def test_one_frames_spans_form_one_tree(scene):
    _, rec = _recorded_frame(scene, loop_chunk=2)
    names = Counter(s.name for s in rec)
    (frame,) = [s for s in rec if s.name == "frame"]
    assert names["tile"] == 2
    assert names["frame.plan"] == names["frame.fetch"] == names["frame.reorder"] == 1
    assert names["pool.chunk"] >= 2 and names["pool.sync"] == names["pool.chunk"] + 2
    by_id = {s.id: s for s in rec}
    assert len(by_id) == len(rec) and frame.parent is None
    parent_names = {}
    for s in rec:
        assert s.frame == frame.id and 0 < s.start <= s.end
        if s is not frame:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            parent_names.setdefault(s.name, set()).add(p.name)
    assert parent_names == {"frame.plan": {"frame"}, "tile": {"frame"}, "frame.fetch": {"frame"},
                            "frame.reorder": {"frame"}, "pool.chunk": {"tile"},
                            "pool.sync": {"tile"}}
    assert all(s.counters == {} for s in rec if s.name not in ("pool.chunk",))
    # a read of the count, then chunks and reads in turn, never overlapping
    for tile in (s for s in rec if s.name == "tile"):
        kids = [s for s in rec if s.parent == tile.id]
        assert [s.name for s in kids] == ["pool.sync"] + ["pool.chunk", "pool.sync"] * (
            len(kids) // 2)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))


def test_live_iterations_are_the_iterations_that_find_the_pool_non_empty(scene):
    """A chunk of 4 runs 4 iterations, drained ones included; chunks of 1
    stop at the first empty read, so each of their iterations is live."""
    _, one = _recorded_frame(scene, loop_chunk=1)
    _, four = _recorded_frame(scene, loop_chunk=4)
    one = [s.counters for s in one if s.name == "pool.chunk"]
    four = [s.counters for s in four if s.name == "pool.chunk"]
    assert all(c == {"iters": 1, "live_iters": 1, "graph": 0} for c in one)
    assert all(c["iters"] == 4 and 0 < c["live_iters"] <= 4 for c in four)
    assert sum(c["live_iters"] for c in four) == len(one) < sum(c["iters"] for c in four)


def test_spans_lie_on_the_profilers_clock(scene):
    """A frame under a CPU profile records its spans, each inside the
    `record_function` range around the frame as the profiler reports it;
    the next frame, without the profile, records none."""
    r = RaytracerRenderer(RenderConfig(**CFG, loop_chunk=2), device="cpu")
    timing.take_spans()
    with _profiled() as prof:
        with torch.profiler.record_function("frame_under_test"):
            r.render_u32(scene)
    rec = timing.take_spans()
    (outer,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "frame_under_test"]
    lo, hi = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    assert len(rec) > 5 and all(lo <= s.start <= s.end <= hi for s in rec)
    assert not timing.ON
    r.render_u32(scene)
    assert timing.take_spans() == []


def test_self_time_takes_the_union_of_the_named_children():
    S = fb_spans.Span
    frame = S("frame", 0.0, 10.0, 1, None, 1, {})
    rec = [frame, S("frame.plan", 0.0, 1.0, 2, 1, 1, {}), S("tile", 1.0, 5.0, 3, 1, 1, {}),
           S("tile", 4.0, 7.0, 4, 1, 1, {}), S("pool.chunk", 2.0, 3.0, 5, 3, 1, {}),
           S("frame.fetch", 7.5, 9.0, 6, 1, 1, {}), S("tile", 20.0, 30.0, 7, 1, 1, {})]
    assert fb_spans.self_seconds(frame, rec) == pytest.approx(1.5)
    assert fb_spans.self_seconds(frame, rec, ("tile", "frame.fetch")) == pytest.approx(2.5)
    assert fb_spans.self_seconds(rec[2], rec) == pytest.approx(3.0)


def test_device_busy_time_counts_a_kernel_under_its_operator_once():
    def ev(device, start, end):
        return types.SimpleNamespace(device_type=device,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev(DeviceType.CPU, 0, 900),  # aten::mul, whose kernel follows
              ev(DeviceType.CUDA, 100, 400), ev(DeviceType.CUDA, 300, 600),
              ev(DeviceType.CPU, 1000, 1050), ev(DeviceType.CUDA, 1100, 1200)]
    assert timing.device_busy_ms(events) == pytest.approx(0.6)
    assert timing.device_busy_ms(events[:1]) == 0.0
