"""The span metrics' arithmetic on synthetic span and event lists: self
time, per-frame sums, the frames' check, idle gaps named by the innermost
program span, and each reader on a hand-built traced run."""

import types

import pytest

import fb_util
from framebench import spans, spec
from framebench.spans import Span
from framebench.tracing import Event

K, R = "kernel", "runtime"
SPAN_METRICS = ("renderer_host_ms_per_frame", "fetch_wait_ms_per_frame", "pool_sync_ms_per_frame",
                "pool_live_iter_pct", "pool_idle_ms_per_frame")


def _frame(fid, t0):
    """One frame of 10 s from t0: plan 1 s, a tile of 6 s holding two chunks
    (4 iterations each, 3 and 1 live) with a read after each, fetch 2 s,
    reorder 1 s."""
    def s(name, a, b, sid, parent, **c):
        return Span(name, t0 + a, t0 + b, fid + sid, None if parent is None else fid + parent,
                    fid, c)

    return [s("frame", 0, 10, 0, None), s("frame.plan", 0, 1, 1, 0), s("tile", 1, 7, 2, 0),
            s("pool.chunk", 1.5, 3, 3, 2, iters=4, live_iters=3), s("pool.sync", 3, 3.5, 4, 2),
            s("pool.chunk", 3.5, 5, 5, 2, iters=4, live_iters=1), s("pool.sync", 5, 5.5, 6, 2),
            s("frame.fetch", 7, 9, 7, 0), s("frame.reorder", 9, 10, 8, 0)]


def _ctx(rec, events, frames):
    ctx = types.SimpleNamespace(events=events, window=(0.0, 20.0), window_s=20.0, frames=frames)
    ctx.spans = rec  # as `spans.of` leaves them once taken from the port
    return ctx


# device work: a kernel in each frame's plan and tile, idle inside the chunks
EVENTS = [Event("k", K, t, 0.5) for t in (0.2, 1.0, 4.0, 6.0, 10.2, 11.0, 14.0, 16.0)] + [
    Event("cudaMemcpyAsync", R, 3.0, 0.5)]
TWO = _frame(100, 0.0) + _frame(200, 10.0)


def test_self_time_and_per_frame_sums():
    f = TWO[0]
    assert spans.self_seconds(f, TWO) == pytest.approx(0.0)
    assert spans.self_seconds(f, TWO, ("tile", "frame.fetch")) == pytest.approx(2.0)
    assert spans.self_seconds(TWO[2], TWO) == pytest.approx(2.0)
    assert spans.total_seconds(spans.named(TWO, "pool.sync")) == pytest.approx(2.0)
    assert spans.frames(TWO, 2) == [TWO[0], TWO[9]]
    assert spans.frames(TWO, 3) is None and spans.frames([], 0) is None


def test_idle_gaps_take_the_innermost_program_span():
    """A whole gap goes to the span open at its middle: 1.5-4.0 s to the
    first chunk, 4.5-6.0 s to the second read, 6.5-10.2 s to the fetch."""
    idle = spans.idle_by_span(TWO, EVENTS, (0.0, 20.0))
    assert idle == pytest.approx({"frame.plan": 0.2 + 0.3 + 0.3, "pool.chunk": 2.5 + 2.5,
                                  "pool.sync": 1.5 + 1.5, "frame.fetch": 3.7 + 3.5})


@pytest.mark.parametrize("metric,value", [
    ("renderer_host_ms_per_frame", 2000.0), ("fetch_wait_ms_per_frame", 2000.0),
    ("pool_sync_ms_per_frame", 1000.0), ("pool_live_iter_pct", 50.0),
    ("pool_idle_ms_per_frame", 2500.0)])
def test_each_reader_on_a_traced_run(metric, value):
    read = spec.reader(metric, fb_util.BENCH_DIR).read
    assert read(_ctx(list(TWO), EVENTS, 2)) == pytest.approx(value)
    assert read(_ctx(list(TWO), EVENTS, 3)) is None  # the frames do not match the harness's


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_read_nothing_without_spans_or_a_device(metric, monkeypatch):
    read = spec.reader(metric, fb_util.BENCH_DIR).read
    assert read(_ctx([], EVENTS, 2)) is None
    # a port without the recorder gives no spans; nor does a trace without device work
    monkeypatch.setattr(spans, "_take", lambda: [])
    assert read(types.SimpleNamespace(events=EVENTS, window=(0.0, 20.0), frames=2)) is None
    monkeypatch.setattr(spans, "_take", lambda: list(TWO))
    host_only = [e for e in EVENTS if e.kind == R]
    assert read(types.SimpleNamespace(events=host_only, window=(0.0, 20.0), frames=2)) is None


def test_pool_metrics_read_nothing_on_a_frame_without_the_pool():
    rec = [s for s in TWO if not s.name.startswith("pool.")]
    for metric in SPAN_METRICS:
        value = spec.reader(metric, fb_util.BENCH_DIR).read(_ctx(rec, EVENTS, 2))
        assert (value is None) == metric.startswith("pool_"), metric


def test_spans_are_taken_from_the_port_once():
    import torch

    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing

    timing.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        timing.frame_recording()  # as the port's frame decides at its entry
        with timing.span("frame"):
            with timing.span("pool.chunk", iters=4):
                pass
    ctx = types.SimpleNamespace(events=EVENTS, window=(0.0, 20.0), frames=1)
    f, c = spans.of(ctx)
    assert f.name == "frame" and 0 < f.end - f.start < 1.0
    assert c.parent == f.id and c.frame == f.id and c.counters == {"iters": 4}
    assert spans.of(ctx) == [f, c] and timing.take_spans() == []
