"""The share of the pool loop's chunks that were replayed as a CUDA graph, in
%: 100 * sum of `graph` / the number of the port's `pool.chunk` spans. A chunk
run eagerly or captured reads 0. Nothing read without those spans (a frame
that takes no pool), when a chunk lacks the counter (a port without chunk
graphs), or when the `frame` spans do not number the traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    chunks = rec and spans.named(rec, "pool.chunk")
    if not fr or not chunks or any("graph" not in c.counters for c in chunks):
        return None
    return 100.0 * sum(c.counters["graph"] for c in chunks) / len(chunks)
