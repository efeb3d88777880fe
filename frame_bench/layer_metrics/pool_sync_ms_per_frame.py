"""The host blocked on the pool loop's reads of its count, in ms per traced
frame: the port's `pool.sync` spans. Nothing read without them (a frame that
takes no pool), or when the `frame` spans do not number the traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    sync = rec and spans.named(rec, "pool.sync")
    return 1e3 * spans.total_seconds(sync) / len(fr) if fr and sync else None
