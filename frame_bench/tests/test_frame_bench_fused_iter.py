"""The reader of `pool_fused_iter_pct` (the share of pool iterations that ran
as the port's fused iteration): the share where the port counts the put
kernel and the traced frames have pool chunks, nothing where it does not
(a port without the fused iteration), where no pool ran or where the
`frame` spans do not number the frames; and its entry in BENCHMARK.json."""

import types

import pytest

import fb_util
from framebench import spans, spec

METRIC = "pool_fused_iter_pct"


def _span(i, name, parent=None, frame=0, **counters):
    return spans.Span(name, float(i), float(i) + 0.5, i, parent, frame, counters)


def _read(counters, chunks=(96, 96), frames=1):
    rec = [_span(0, "frame")] + [_span(1 + i, "pool.chunk", parent=0, iters=n)
                                  for i, n in enumerate(chunks)]
    ctx = types.SimpleNamespace(counters=counters, frames=frames, spans=rec)
    return spec.reader(METRIC, fb_util.BENCH_DIR).read(ctx)


def test_reads_the_share_of_iterations_that_ran_fused():
    assert _read({"pool_put": 192, "shade_eval_rows": 193}) == pytest.approx(100.0)
    assert _read({"pool_put": 96, "shade_eval_rows": 193}) == pytest.approx(50.0)
    assert _read({"pool_put": 0, "shade_eval_rows": 193}) == 0.0


def test_reads_nothing_without_the_counter_the_pool_or_the_frames():
    assert _read({"shade_eval_rows": 193}) is None  # a port without the fused iteration
    assert _read({"pool_put": 0, "light_shade": 16}, chunks=()) is None  # no pool
    assert _read({"pool_put": 192}, frames=2) is None  # the frame spans do not match


def test_benchmark_entry_moves_frame_ms_in_the_pool_cells():
    bench = spec.load_benchmark()
    m = [e for e in bench["per_layer"] if e["name"] == METRIC]
    assert len(m) == 1
    assert m[0] == {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter",
                    "layer": "node glue (ops/trace.py, ops/intersect.py, ops/shading.py)",
                    "moves": "frame_ms", "workloads": ["realistic_1080p", "extreme_480x270"]}
