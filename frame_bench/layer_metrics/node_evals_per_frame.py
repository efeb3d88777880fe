"""Node evaluations of the pool loop per traced frame: the port's launch
counter of `shade_eval_rows` (`kernels.LAUNCHES`), which counts every call,
drained pool iterations included. Nothing read when the kernel never ran."""


def read(ctx):
    n = ctx.counters.get("shade_eval_rows", 0)
    return n / ctx.frames if n else None
