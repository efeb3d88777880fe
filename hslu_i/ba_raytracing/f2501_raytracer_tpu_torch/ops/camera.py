"""Primary-ray generation and anti-aliasing sample tables.

Pixel (px, py) maps to scene coordinates (px*w2s_w, py*w2s_h, 0) — no
half-pixel offset (ref renderer/mod.rs:118-120, 172-179) — and every primary
ray points from RENDER_RAY_FOCUS through those coordinates
(ref raytracer_renderer.rs:1148-1149). All AA samples of a pixel jitter the
*origin* only and share the unjittered direction (raytracer_renderer.rs:1204).

AA sample table (ref raytracer_renderer.rs:105-127, 876-916, 1054-1107):
* total = samples_per_pixel rounded up to a multiple of 8
* entries: [0,0], then 8×[1,1], then Poisson-disk jitter in [0,1.2]^2 with
  min distance 3/total (only with anti_aliasing_randomness)
* each entry is scaled by (w2s_w, w2s_h) * scale_factor, where scale_factor
  is sqrt(5)/2.05 under rotation_scale else 0.85
* each sample is biased along one of 8 unit directions (a grid rotated by
  atan(0.5) under rotation_scale). The direction cycles per *lane within a
  packet*: the reference's scalar path (packet width 1, the default build)
  therefore always uses direction 0, while the simd_render path cycles all 8.
  `packet_lanes` selects which behaviour to reproduce.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..config import RenderConfig
from .sampling import poisson_disk


def pixel_scene_coords(cfg: RenderConfig, px: np.ndarray, py: np.ndarray) -> np.ndarray:
    cam = cfg.camera
    x = px.astype(np.float32) * np.float32(cam.w2s_width)
    y = py.astype(np.float32) * np.float32(cam.w2s_height)
    z = np.zeros_like(x)
    return np.stack([x, y, z], axis=-1)


def tile_major_order(width: int, height: int, ts: int = 16) -> np.ndarray:
    """Permutation mapping tile-major position -> row-major pixel index.

    The Pallas kernels cull triangle blocks per 256-ray tile; with row-major
    pixel order one kernel tile is a 256-pixel-wide strip whose shadow
    frustums span the whole scene, so the per-ray gates never agree to skip
    a block. Square ts×ts patches keep each kernel tile spatially tight.
    Pure host-side relabeling: results are scattered back through the same
    permutation, the traced math is unchanged."""
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    out = [
        idx[ty : ty + ts, tx : tx + ts].reshape(-1)
        for ty in range(0, height, ts)
        for tx in range(0, width, ts)
    ]
    return np.concatenate(out) if out else idx.reshape(-1)


def antialiasing_sampling_directions(rotation_scale: bool) -> np.ndarray:
    """The 8 sampling bias directions [t,l,b,r,tl,tr,bl,br]
    (ref raytracer_renderer.rs:876-916)."""
    if rotation_scale:
        ang = math.atan(0.5)
        s, c = math.sin(ang), math.cos(ang)
        x_r = np.array([c, s, 0.0])
        y_r = np.array([-s, c, 0.0])
    else:
        x_r = np.array([1.0, 0.0, 0.0])
        y_r = np.array([0.0, 1.0, 0.0])
    # reference bindings: t = -y_r, l = -x_r, r = x_r, b = y_r (rs:897-904)
    t, l, r, b = -y_r, -x_r, x_r, y_r
    dirs = [t, l, b, r, t + l, t + r, b + l, b + r]
    out = np.stack([d / np.linalg.norm(d) for d in dirs]).astype(np.float32)
    return out


@lru_cache(maxsize=16)
def _aa_table_cached(total: int, randomness: bool, seed: int) -> tuple:
    samples = [[0.0, 0.0]] + [[1.0, 1.0]] * 8
    if randomness:
        pts = poisson_disk([1.2, 1.2], 3.0 / total, k=30, seed=seed ^ 0xAA5EED)
        samples.extend(pts[: total - 1].tolist())
    else:
        samples.extend([[1.0, 1.0]] * total)
    table = np.asarray(samples[:total], dtype=np.float32)
    return (table,)


def antialiasing_weighted_offsets(
    cfg: RenderConfig, packet_lanes: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """(offsets (U, 3), weights (U,)): the AA offset table with identical
    rows folded into one weighted sample.

    The table's first 9 entries are [0,0] + 8x[1,1]
    (ref raytracer_renderer.rs:105-127); under the scalar build's
    direction-cycling (packet_lanes=1, ops docstring above) the eight [1,1]
    rows bias along the SAME direction and are therefore the same ray.
    AA contributions are weight-linear (color_sum * 1/total,
    rs:1001-1015), so tracing the ray once with weight count/total is
    algebraically exact — multiplicities are powers of two, so even the
    weight scaling is exact in f32."""
    offsets = antialiasing_offsets(cfg, packet_lanes)
    total = offsets.shape[0]
    uniq, counts = np.unique(offsets, axis=0, return_counts=True)
    weights = (counts / np.float32(total)).astype(np.float32)
    return uniq.astype(np.float32), weights


def antialiasing_offsets(cfg: RenderConfig, packet_lanes: int = 1) -> np.ndarray:
    """Per-sample origin offsets (total, 3) in scene units."""
    total = cfg.total_aa_rays
    (table,) = _aa_table_cached(total, cfg.anti_aliasing_randomness, cfg.seed)
    dirs = antialiasing_sampling_directions(cfg.anti_aliasing_rotation_scale)
    cam = cfg.camera
    scale_factor = math.sqrt(5.0) / 2.05 if cfg.anti_aliasing_rotation_scale else 0.85
    offsets = np.zeros((total, 3), dtype=np.float32)
    for k in range(total):
        bias = dirs[(k % packet_lanes) % 8]
        offsets[k, 0] = table[k, 0] * cam.w2s_width * scale_factor * bias[0]
        offsets[k, 1] = table[k, 1] * cam.w2s_height * scale_factor * bias[1]
    return offsets
