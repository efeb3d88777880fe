"""Light preparation of the plain reference: value-maximised colours and
the soft-shadow light clouds, worked out from the raw lights.

The cloud follows the reference renderer (ref scene/lighting/light.rs:183-226)
as the system under test draws it: once per frame from a generator seeded by
the render seed (`seed + 0x51DE`), each light in scene order drawing one
Poisson-disk seed and, if the disk falls short, uniform padding. The
Poisson-disk sampler is a frozen copy of Bridson's algorithm as that system
runs it, so the same seed gives the same cloud.
"""

from __future__ import annotations

import numpy as np


def _srgb_encode(c):
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.0031308, 12.92 * c,
                    1.055 * np.power(np.maximum(c, 0.0), 1 / 2.4) - 0.055)


def _srgb_decode(c):
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.04045, c / 12.92, np.power((c + 0.055) / 1.055, 2.4))


def maximize_value(color) -> np.ndarray:
    """ref src/color.rs:124-131: linear -> sRGB, HSV value set to 1, back."""
    rgb = _srgb_encode(np.asarray(color, dtype=np.float64))
    mx = np.max(rgb, axis=-1, keepdims=True)
    rgb = np.where(mx > 0.0, rgb / np.where(mx > 0.0, mx, 1.0), 1.0)
    return _srgb_decode(rgb).astype(np.float32)


def poisson_disk(dims, radius, k, seed, max_points):
    """Bridson's algorithm over the box [0, dims]^d."""
    dims = np.asarray(dims, dtype=np.float64)
    nd = dims.shape[0]
    rng = np.random.default_rng(seed)
    cell = radius / np.sqrt(nd)
    grid_shape = np.maximum(np.ceil(dims / cell).astype(int), 1)
    grid = -np.ones(grid_shape, dtype=np.int64)

    def grid_idx(p):
        return tuple(np.minimum((p // cell).astype(int), grid_shape - 1))

    p0 = rng.random(nd) * dims
    points, active = [p0], [0]
    grid[grid_idx(p0)] = 0
    offsets = np.array(np.meshgrid(*([np.arange(-2, 3)] * nd), indexing="ij")).reshape(nd, -1).T
    while active and len(points) < max_points:
        ai = rng.integers(len(active))
        base = points[active[ai]]
        placed = False
        for _ in range(k):
            direction = rng.normal(size=nd)
            norm = np.linalg.norm(direction)
            if norm == 0.0:
                continue
            direction /= norm
            cand = base + direction * (radius * (1.0 + rng.random()))
            if np.any(cand < 0.0) or np.any(cand >= dims):
                continue
            ci = np.array(grid_idx(cand))
            ok = True
            for off in offsets:
                ni = ci + off
                if np.any(ni < 0) or np.any(ni >= grid_shape):
                    continue
                pi = grid[tuple(ni)]
                if pi >= 0 and np.linalg.norm(points[pi] - cand) < radius:
                    ok = False
                    break
            if ok:
                grid[tuple(ci)] = len(points)
                points.append(cand)
                active.append(len(points) - 1)
                placed = True
                break
        if not placed:
            active.pop(ai)
    return np.asarray(points, dtype=np.float32)


def expand_lights(lights, per_light: int, w2s, seed: int):
    """(positions (L, 3), colours (L, 3), intensities (L,)) float32: each raw
    light replaced by `per_light` lights at 1/per_light of its intensity,
    offset inside a cube of 1.725 + per_light / 20 window units scaled by
    the window-to-scene factors `w2s` (3,)."""
    rng = np.random.default_rng(seed + 0x51DE)
    w2s = np.asarray(w2s, dtype=np.float32)
    pos, col, inten = [], [], []
    for light in lights:
        p = np.asarray(light["position"], np.float32)
        c = maximize_value(np.asarray(light["color"], np.float32))
        if per_light == 1:
            pos.append(p[None])
            col.append(c[None])
            inten.append([light["intensity"]])
            continue
        side = 1.725 + per_light / 20.0
        pts = poisson_disk([side] * 3, 4.0 / per_light, per_light,
                           int(rng.integers(0, 2**31 - 1)), per_light)
        if pts.shape[0] < per_light:
            pad = rng.random((per_light - pts.shape[0], 3), dtype=np.float32) * side
            pts = np.concatenate([pts, pad], axis=0)
        pos.append(p[None] + pts[:per_light] * w2s[None])
        col.append(np.repeat(c[None], per_light, 0))
        inten.append([light["intensity"] * (1.0 / per_light)] * per_light)
    return (np.concatenate(pos).astype(np.float32), np.concatenate(col).astype(np.float32),
            np.asarray(np.concatenate(inten), np.float32))
