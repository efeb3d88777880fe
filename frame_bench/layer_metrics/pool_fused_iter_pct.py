"""The share of the pool loop's iterations that ran as the port's fused
iteration (five kernels: the take, the cast, the hit record, the node, the
put), in %: 100 * the port's counter of the put kernel
(`kernels.LAUNCHES["pool_put"]`, one a fused iteration, replays included) /
the sum of `iters` over the `pool.chunk` spans of the traced frames.
Nothing read without that counter (a port that lacks the fused iteration),
without `pool.chunk` spans (a frame that takes no pool), or when the
`frame` spans do not number the traced frames."""

from framebench import spans

KEY = "pool_put"


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    chunks = rec and spans.named(rec, "pool.chunk")
    if KEY not in ctx.counters or not fr or not chunks:
        return None
    iters = sum(c.counters["iters"] for c in chunks)
    return 100.0 * ctx.counters[KEY] / iters if iters else None
