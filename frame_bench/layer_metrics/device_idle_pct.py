"""Share of the traced window in which no operation ran on the device: 100 *
(1 - union of the device operations' intervals / window). Nothing read when
no operation ran."""

from framebench import tracing


def read(ctx):
    busy = tracing.busy_seconds(ctx.events, ctx.window)
    return 100.0 * (1.0 - busy / ctx.window_s) if busy > 0 else None
