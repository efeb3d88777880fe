"""`pool_graph_chunk_pct` on synthetic spans: 100 * Σ `graph` over the
`pool.chunk` spans, nothing where a chunk lacks the counter, where no chunk
was recorded, or where the `frame` spans do not number the traced frames."""

import types

import pytest

import fb_util
from framebench import spec
from framebench.spans import Span
from framebench.tracing import Event

EVENTS = [Event("k", "kernel", t, 0.5) for t in (0.2, 1.0, 4.0, 6.0)]


def _frame(fid, t0, graphs):
    """One frame of 10 s from t0: a tile holding a chunk per entry of
    `graphs` (its `graph` counter; None: no counter), each with its read."""
    rec = [Span("frame", t0, t0 + 10, fid, None, fid, {}),
           Span("tile", t0 + 1, t0 + 9, fid + 1, fid, fid, {})]
    for i, g in enumerate(graphs):
        c = {"iters": 4, "live_iters": 2} | ({} if g is None else {"graph": g})
        a = t0 + 1.5 + i
        rec += [Span("pool.chunk", a, a + 0.5, fid + 2 + 2 * i, fid + 1, fid, c),
                Span("pool.sync", a + 0.5, a + 1, fid + 3 + 2 * i, fid + 1, fid, {})]
    return rec


def _read(rec, frames):
    ctx = types.SimpleNamespace(events=EVENTS, window=(0.0, 20.0), window_s=20.0,
                                frames=frames)
    ctx.spans = rec  # as `spans.of` leaves them once taken from the port
    return spec.reader("pool_graph_chunk_pct", fb_util.BENCH_DIR).read(ctx)


@pytest.mark.parametrize("graphs,value", [
    ([[1, 1, 1], [1, 1]], 100.0),  # every chunk replayed
    ([[0, 0, 1], [1, 1, 1]], 400.0 / 6),  # a first eager and a captured chunk
    ([[0], [0, 0]], 0.0),  # no chunk replayed
])
def test_reads_the_share_of_replayed_chunks(graphs, value):
    rec = _frame(100, 0.0, graphs[0]) + _frame(200, 10.0, graphs[1])
    assert _read(rec, 2) == pytest.approx(value)
    assert _read(rec, 3) is None  # the frames do not match the harness's


def test_reads_nothing_without_the_counter_or_the_chunks():
    assert _read(_frame(100, 0.0, [1, None]), 1) is None  # a port without chunk graphs
    assert _read(_frame(100, 0.0, []), 1) is None  # a frame that takes no pool
    assert _read([], 1) is None
