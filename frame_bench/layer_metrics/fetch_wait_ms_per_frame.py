"""The host waiting for the device's tail and the copy of the pixels back,
in ms per traced frame: the port's `frame.fetch` spans. Nothing read without
the port's spans, or when the `frame` spans do not number the traced
frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    fetch = rec and spans.named(rec, "frame.fetch")
    return 1e3 * spans.total_seconds(fetch) / len(fr) if fr and fetch else None
