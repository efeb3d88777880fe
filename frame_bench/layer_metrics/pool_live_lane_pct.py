"""The share of the pool loop's lanes that serviced a pending ray, in %: 100
* sum of `live_lanes` / sum of `lanes` (iterations x the pool's width W)
over the port's `pool.chunk` spans. Drained iterations and the dead lanes
of a window that the pool no longer fills count as lanes. Nothing read
without those counters (a port that does not count lanes), without chunks
(a frame that takes no pool), or when the `frame` spans do not number the
traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    chunks = rec and spans.named(rec, "pool.chunk")
    if not fr or not chunks or any({"lanes", "live_lanes"} - set(c.counters) for c in chunks):
        return None
    return 100.0 * sum(c.counters["live_lanes"] for c in chunks) / sum(
        c.counters["lanes"] for c in chunks)
