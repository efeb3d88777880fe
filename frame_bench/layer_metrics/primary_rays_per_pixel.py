"""The primary rays a frame traces per pixel of the frame: the sum of
`rays` over the sum of `pixels` of the traced frames' `frame.plan` spans
(the port's plan: every tile's AA samples, padding rays included). Nothing
read without the port's spans or those counters, or when the `frame` spans
do not number the traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    plans = rec and spans.named(rec, "frame.plan")
    if not fr or not plans or any({"rays", "pixels"} - set(p.counters) for p in plans):
        return None
    return sum(p.counters["rays"] for p in plans) / sum(p.counters["pixels"] for p in plans)
