"""The host's runtime calls that launch device work, per traced frame (a
CUDA graph replay counts once). Nothing read when the trace holds none."""

from framebench import tracing


def read(ctx):
    n = tracing.launch_count(ctx.events)
    return n / ctx.frames if n else None
