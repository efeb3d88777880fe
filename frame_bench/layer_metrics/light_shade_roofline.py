"""`light_shade`'s share of its roofline, in %: over every call of one tile
(the harness's sample tile of the first traced frame), the sum of each
call's bound (the larger of its bytes over 3.35 TB/s and the f32 operations
its inputs need over 67 TFLOP/s) over the sum of its device time from the
trace. Nothing read when the tile made no call or the trace lacks them."""

from framebench import roofline

CAPTURE = ("light_shade",)


def read(ctx):
    return roofline.roofline_pct("light_shade", ctx.captured.get("light_shade", []))
