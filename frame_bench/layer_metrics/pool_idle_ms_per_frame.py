"""Device idle while the host enqueues the pool loop's chunks, in ms per
traced frame: the gaps between device operations whose innermost program
span at their middle is the port's `pool.chunk`. Nothing read without those
spans (a frame that takes no pool), or when the `frame` spans do not number
the traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    if not fr or not spans.named(rec, "pool.chunk"):
        return None
    return 1e3 * spans.idle_by_span(rec, ctx.events, ctx.window).get("pool.chunk", 0.0) / len(fr)
