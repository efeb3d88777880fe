"""Output backends (ref src/output/): PNG file writer + encoders.

The reference also drives a live `minifb` window (src/output/window.rs);
in a headless environment the equivalent is the progressive-callback
hook on `RaytracerRenderer.render` plus `FileOutput`. The port's copy of the
JAX package's `output/` (none of which imports JAX).
"""

from __future__ import annotations

import numpy as np

from ..framebuffer import ImageBuffer
from ..ops.colorops import linear_to_u8, pack_u32, u8_to_linear, unpack_u32
from .png_io import read_png, write_png


class OutputColorEncoder:
    """Pixel (linear f32 RGB) <-> packed u32 (ref output/mod.rs:13-16)."""

    @staticmethod
    def to_output(pixel: np.ndarray) -> np.ndarray:
        return pack_u32(linear_to_u8(pixel))

    @staticmethod
    def from_output(px: np.ndarray) -> np.ndarray:
        return u8_to_linear(unpack_u32(px))


# The window and file encoders share one implementation (both convert
# LinSrgb<f32> -> u8 without a gamma transfer; ref output/file.rs:61-71,
# output/window.rs:105-115).
FileColorEncoder = OutputColorEncoder
WindowColorEncoder = OutputColorEncoder


class FileOutput:
    """PNG writer (ref output/file.rs:20-56)."""

    def __init__(self, path):
        self.path = path

    def render_buffer(self, buffer: ImageBuffer) -> None:
        write_png(self.path, buffer.as_u8())


__all__ = [
    "OutputColorEncoder",
    "FileColorEncoder",
    "WindowColorEncoder",
    "FileOutput",
    "read_png",
    "write_png",
]
