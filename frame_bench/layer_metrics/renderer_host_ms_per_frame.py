"""The renderer's own host time, in ms per traced frame: the self time of
the port's `frame` span less its `tile` and `frame.fetch` children, i.e. the
plan, the uploads of its tables, the launch groups' slicing and the host
reorder after the fetch. Nothing read without the port's spans, or when the
`frame` spans do not number the traced frames."""

from framebench import spans


def read(ctx):
    rec = spans.of(ctx)
    fr = rec and spans.frames(rec, ctx.frames)
    if not fr:
        return None
    return 1e3 * sum(spans.self_seconds(f, rec, ("tile", "frame.fetch")) for f in fr) / len(fr)
