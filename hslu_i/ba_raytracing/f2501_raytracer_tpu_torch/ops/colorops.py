"""Color math: linear RGB pipeline + the reference's HSV value-maximization.

The reference shades in linear sRGB (`ColorType = palette::LinSrgb<f32>`,
ref src/helpers.rs:12) and applies `maximize_value` — convert to gamma sRGB,
force HSV value to 1, convert back — to every light color
(ref src/color.rs:124-131; used scene/lighting/light.rs:96,178).

Output encoding quirk (must copy for golden parity): the PNG/window writers
convert `LinSrgb<f32>` straight to `LinSrgb<u8>` via palette `into_format`,
i.e. round(clamp(c)*255) with NO gamma transfer (ref src/output/file.rs:61-71,
src/output/window.rs:105-115).
"""

from __future__ import annotations

import numpy as np


def srgb_encode(c: np.ndarray) -> np.ndarray:
    """Linear -> gamma sRGB (palette's transfer function)."""
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.0031308, 12.92 * c, 1.055 * np.power(np.maximum(c, 0.0), 1 / 2.4) - 0.055)


def srgb_decode(c: np.ndarray) -> np.ndarray:
    """Gamma sRGB -> linear."""
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.04045, c / 12.92, np.power((c + 0.055) / 1.055, 2.4))


def maximize_value(color) -> np.ndarray:
    """ref src/color.rs:124-131: linear -> sRGB -> HSV with V=1 -> linear.

    Setting HSV value to 1 while keeping hue/saturation is exactly dividing
    the gamma-sRGB components by their max (black maps to white, like the
    reference's HSV round-trip does).
    """
    rgb = srgb_encode(np.asarray(color, dtype=np.float64))
    mx = np.max(rgb, axis=-1, keepdims=True)
    rgb = np.where(mx > 0.0, rgb / np.where(mx > 0.0, mx, 1.0), 1.0)
    return srgb_decode(rgb).astype(np.float32)


def linear_to_u8(c: np.ndarray) -> np.ndarray:
    """palette `into_format::<u8>()`: round-half-up of clamp(c)*255, NO gamma."""
    c = np.clip(np.asarray(c, dtype=np.float32), 0.0, 1.0)
    return np.floor(c * 255.0 + 0.5).astype(np.uint8)


def u8_to_linear(c: np.ndarray) -> np.ndarray:
    return np.asarray(c, dtype=np.float32) / 255.0


def pack_u32(rgb_u8: np.ndarray) -> np.ndarray:
    """0xFFRRGGBB packing (palette `u32::from(Srgb<u8>)`, used by minifb/PNG
    round-trip; ref src/output/window.rs:105-115)."""
    r = rgb_u8[..., 0].astype(np.uint32)
    g = rgb_u8[..., 1].astype(np.uint32)
    b = rgb_u8[..., 2].astype(np.uint32)
    return (np.uint32(0xFF) << 24) | (r << 16) | (g << 8) | b


def unpack_u32(px: np.ndarray) -> np.ndarray:
    px = np.asarray(px, dtype=np.uint32)
    r = (px >> 16) & 0xFF
    g = (px >> 8) & 0xFF
    b = px & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.uint8)
