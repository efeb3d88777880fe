"""Host-side framebuffer (ref src/image_buffer.rs).

The reference shares one `[AtomicU32; W*H]` between rayon render workers and
the display thread, with cache-line-aligned tile chunking to avoid false
sharing. On TPU the frame is computed device-side; this buffer is the host
assembly target that tiles are committed into as they finish (progressive
partial renders remain observable, mirroring the producer/consumer split of
ref main.rs:330-347).
"""

from __future__ import annotations

import numpy as np

from .ops.colorops import linear_to_u8, pack_u32, u8_to_linear, unpack_u32


class ImageBuffer:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        # linear-RGB accumulation plane + validity plane; invalid pixels keep
        # the 0 (black) background like the reference's untouched atomics
        self.color = np.zeros((height, width, 3), dtype=np.float32)
        self.valid = np.zeros((height, width), dtype=bool)

    def __len__(self) -> int:
        return self.width * self.height

    def commit_tile(self, y0: int, x0: int, color: np.ndarray, valid: np.ndarray):
        h, w = valid.shape
        view_c = self.color[y0 : y0 + h, x0 : x0 + w]
        view_v = self.valid[y0 : y0 + h, x0 : x0 + w]
        view_c[valid] = color[valid]
        view_v |= valid

    def as_linear(self) -> np.ndarray:
        return np.where(self.valid[..., None], self.color, 0.0).astype(np.float32)

    def as_u8(self) -> np.ndarray:
        """Linear f32 -> u8 with NO gamma, the reference's output quirk
        (ref output/file.rs:61-71)."""
        return linear_to_u8(self.as_linear())

    def get_u32_slice(self) -> np.ndarray:
        """0xFFRRGGBB view (ref image_buffer.rs:39-44)."""
        return pack_u32(self.as_u8()).reshape(-1)

    @classmethod
    def from_u32(cls, px: np.ndarray, width: int, height: int) -> "ImageBuffer":
        """Rebuild from a packed 0xFFRRGGBB plane. Written pixels carry
        alpha 0xFF (colorops.pack_u32); 0x00000000 = never written, exactly
        an untouched atomic in the reference's zeroed buffer."""
        px = px.reshape(height, width)
        buf = cls(width, height)
        buf.color = u8_to_linear(unpack_u32(px))
        buf.valid[:] = (px >> 24) != 0
        return buf
