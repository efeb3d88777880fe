"""The port's program spans, recorded while the traced window's profiler
runs, and the arithmetic the span metrics read from them.

The port records a span at each boundary of its renderer and of its pool
loop (`utils/timing.py` of the port): `frame`, and inside it `frame.plan`,
a `tile` per tile, `frame.fetch` and `frame.reorder`; inside a tile a
`pool.chunk` per chunk of pool iterations (counters `iters`, `live_iters`)
and a `pool.sync` per read of the pool's count. They are taken from the port
once per traced run and kept on the run's context. The port stamps them in
Unix-epoch ns, the clock of the profiler's events, so here they are in
seconds on the `tracing.Event` timeline.

The arithmetic is pure functions over `Span` and `tracing.Event` lists:
* per frame: a sum over the traced frames, divided by the `frame` spans,
  which must number the frames the harness traced;
* self time: a span's duration less the union of its children's intervals
  (the children of the names given), clipped to the span;
* idle by span: each gap between device operations named by the innermost
  program span open at its middle, by `tracing.idle_gaps`' rule.
"""

from __future__ import annotations

import dataclasses

from . import tracing


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float  # seconds, the profiler's clock
    end: float
    id: int
    parent: int | None
    frame: int | None
    counters: dict


def _take() -> list:
    """The spans the port recorded, handed over and cleared there; none from
    a port without the recorder."""
    try:
        from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing
    except ImportError:
        return []
    take = getattr(timing, "take_spans", None)
    if take is None:
        return []
    return [Span(s.name, s.start * 1e-9, s.end * 1e-9, s.id, s.parent, s.frame,
                 dict(s.counters)) for s in take()]


def of(ctx):
    """The traced run's spans, taken from the port at the first call; None
    where there is nothing to read: no span was recorded, or the trace holds
    no device operation (a run on the CPU)."""
    if not hasattr(ctx, "spans"):
        taken = _take()
        ctx.spans = taken if any(e.kind in tracing.DEVICE_KINDS for e in ctx.events) else []
    return ctx.spans or None


def frames(spans, n_frames: int):
    """The `frame` spans, or None unless there are `n_frames` of them."""
    out = [s for s in spans if s.name == "frame"]
    return out if out and len(out) == n_frames else None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def total_seconds(spans) -> float:
    return sum(s.end - s.start for s in spans)


def self_seconds(span: Span, spans, children=None) -> float:
    """`span`'s duration less the part of it that its child spans cover;
    with `children`, only the children of those names count."""
    cover = tracing.union_intervals(
        (max(c.start, span.start), min(c.end, span.end)) for c in spans
        if c.parent == span.id and (children is None or c.name in children)
        and c.end > span.start and c.start < span.end)
    return (span.end - span.start) - sum(b - a for a, b in cover)


def idle_by_span(spans, events, window) -> dict:
    """{innermost program span: device idle seconds} over the window's gaps
    between device operations (`tracing.idle_gaps` with the spans as the
    host's events); gaps outside every span under `host, between
    operations`."""
    device = [e for e in events if e.kind in tracing.DEVICE_KINDS]
    ranges = [tracing.Event(s.name, "cpu", s.start, s.end - s.start) for s in spans]
    return tracing.idle_gaps(device + ranges, window)
