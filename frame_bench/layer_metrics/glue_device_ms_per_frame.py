"""Device time of every kernel that is none of the port's seven hand-written
kernels (matched by kernel name), in ms per traced frame: the node glue's
PyTorch kernels. Nothing read when the trace holds no kernel."""

from framebench import tracing


def read(ctx):
    lo, hi = ctx.window
    kernels = [e for e in ctx.events if e.kind == "kernel" and e.end > lo and e.start < hi]
    if not kernels:
        return None
    glue = sum(e.dur for e in kernels if ctx.wrapper_of(e.name) is None)
    return 1e3 * glue / ctx.frames
