"""`shade_eval_rows`' share of its roofline over the pool loop's calls, in %:
over the calls of the harness's sample tile (of the first traced frame)
whose row count is the pool's width W, the sum of each call's bound (the
larger of its bytes over 3.35 TB/s and the f32 operations its inputs need
over 67 TFLOP/s) over the sum of their device time from the trace. The
tile's one call on all its R rays (the prologue, the widest) is left out.
Nothing read when the tile made no pool call or the trace lacks them."""

from framebench import roofline

CAPTURE = ("shade_eval_rows",)


def read(ctx):
    calls = ctx.captured.get("shade_eval_rows", [])
    if not calls:
        return None
    rows = [c["args"][5].shape[0] for c in calls]
    pool = [c for c, n in zip(calls, rows) if n < max(rows)]
    return roofline.roofline_pct("shade_eval_rows", pool) if pool else None
