"""The reader of `node_light_lanes_pct` (the share of `shade_eval_rows`
launches that took its light-lanes form): the share where the port counts
the form, nothing where it does not (a port without the form) or where
`shade_eval_rows` never ran; and its entry in BENCHMARK.json."""

import types

import pytest

import fb_util
from framebench import spec

METRIC = "node_light_lanes_pct"
KEY = "shade_eval_rows.light_lanes"


def _read(counters):
    ctx = types.SimpleNamespace(counters=counters, frames=1)
    return spec.reader(METRIC, fb_util.BENCH_DIR).read(ctx)


def test_reads_the_share_of_launches_that_took_the_form():
    assert _read({"shade_eval_rows": 1545, KEY: 1536}) == pytest.approx(100 * 1536 / 1545)
    assert _read({"shade_eval_rows": 2512, KEY: 0, "cast_triangles": 2512}) == 0.0


def test_reads_nothing_without_the_counter_or_the_kernel():
    assert _read({"shade_eval_rows": 1545, "cast_triangles": 1545}) is None  # no such form
    assert _read({"shade_eval_rows": 0, KEY: 0, "light_shade": 16}) is None  # no pool
    assert _read({}) is None


def test_benchmark_entry_moves_frame_ms_in_the_extreme_cell():
    bench = spec.load_benchmark()
    m = [e for e in bench["per_layer"] if e["name"] == METRIC]
    assert len(m) == 1 and bench["per_layer"][-1] is m[0]
    assert m[0] == {"name": METRIC, "unit": "%", "better": "higher", "source": "program_counter",
                    "layer": "kernels (ops/kernels.py, csrc/)", "moves": "frame_ms",
                    "workloads": ["extreme_480x270"]}
