"""Live render preview — the headless analogue of the reference's minifb
window (ref src/output/window.rs:31-100, src/output/mod.rs:91-101).

The reference re-blits its framebuffer into a 60 fps window while rayon
workers fill tiles; in a display-less environment the same
producer/consumer behaviour is driven through the renderer's progressive
callback: `TerminalPreview` draws the partially-filled framebuffer into the
terminal with ANSI half-block cells (2 image rows per character row, 24-bit
color, same no-gamma u8 conversion as the window encoder,
ref output/window.rs:105-115) and/or rewrites a partial PNG after each
committed tile so any image viewer doubles as the live window.

Usage:
    preview = TerminalPreview(png_path="partial.png")
    renderer.render(scene, progress=preview)
    preview.finish(buf)
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..framebuffer import ImageBuffer


class TerminalPreview:
    """Progress callback: `progress(buf, frac)` re-draws the frame.

    max_cols — terminal character width of the preview (image is
               nearest-neighbour downsampled to fit)
    fps      — refresh-rate cap (the reference caps its window loop at
               60 fps via minifb's update rate; terminals want less)
    png_path — when set, the partial frame is also rewritten there on
               every (rate-limited) refresh
    term     — draw to the terminal (disable for PNG-only previews)
    """

    def __init__(self, max_cols: int = 96, fps: float = 10.0,
                 png_path=None, term: bool = True, stream=None):
        self.max_cols = max_cols
        self.fps = fps
        self.png_path = png_path
        self.term = term
        self.stream = stream or sys.stderr
        self._last = 0.0
        self._rows_drawn = 0

    def __call__(self, buf: ImageBuffer, frac: float) -> None:
        now = time.monotonic()
        if frac < 1.0 and now - self._last < 1.0 / self.fps:
            return
        self._last = now
        self._draw(buf, frac)

    def finish(self, buf: ImageBuffer) -> None:
        """Draw the completed frame (always, regardless of rate limit)."""
        self._draw(buf, 1.0)

    # -- internals ----------------------------------------------------------

    def _draw(self, buf: ImageBuffer, frac: float) -> None:
        if self.png_path is not None:
            from . import FileOutput

            FileOutput(self.png_path).render_buffer(buf)
        if not self.term:
            return
        u8 = buf.as_u8()  # (H, W, 3), unfilled pixels are black
        H, W = u8.shape[:2]
        cols = min(self.max_cols, W)
        # half-block cells are ~2:1 tall, one cell = 2 image rows
        rows2 = max(2, int(round(H * cols / W)) & ~1)
        ys = (np.arange(rows2) * H) // rows2
        xs = (np.arange(cols) * W) // cols
        img = u8[ys][:, xs]  # (rows2, cols, 3)
        top, bot = img[0::2], img[1::2]
        out = []
        if self._rows_drawn:
            out.append(f"\x1b[{self._rows_drawn + 1}F")  # redraw in place
        for r in range(top.shape[0]):
            line = []
            for c in range(cols):
                tr, tg, tb = top[r, c]
                br, bg, bb = bot[r, c]
                line.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
                )
            out.append("".join(line) + "\x1b[0m\x1b[K\n")
        out.append(f"\x1b[0m\x1b[K  {frac:6.1%}\n")
        self._rows_drawn = top.shape[0] + 1
        self.stream.write("".join(out))
        self.stream.flush()
