"""The share of `shade_eval_rows` launches that took its light-lanes form (a
warp per ray whose lanes take its lights), in %: 100 * the port's counter of
that form (`kernels.LAUNCHES["shade_eval_rows.light_lanes"]`) / its counter
of `shade_eval_rows` launches, over the traced frames. Nothing read without
the form's counter (a port that lacks the form) or when `shade_eval_rows`
never ran."""

KEY = "shade_eval_rows.light_lanes"


def read(ctx):
    n = ctx.counters.get("shade_eval_rows", 0)
    if KEY not in ctx.counters or not n:
        return None
    return 100.0 * ctx.counters[KEY] / n
