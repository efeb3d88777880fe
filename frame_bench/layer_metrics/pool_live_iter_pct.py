"""The share of the pool loop's iterations that found the pool non-empty, in
%: 100 * sum of `live_iters` / sum of `iters` over the port's `pool.chunk`
spans. It counts iterations, not launches. Nothing read without them (a
frame that takes no pool), or when the `frame` spans do not number the
traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    chunks = rec and spans.named(rec, "pool.chunk")
    if not fr or not chunks or any("live_iters" not in c.counters for c in chunks):
        return None
    return 100.0 * sum(c.counters["live_iters"] for c in chunks) / sum(
        c.counters["iters"] for c in chunks)
