"""Deterministic Poisson-disk sampling (Bridson) in 2D/3D.

Host-side (numpy) replacement for the `fast_poisson` crate used by the
reference for AA jitter tables (ref raytracer_renderer.rs:105-127) and
soft-shadow light clouds (ref scene/lighting/light.rs:183-226).

The reference re-draws these from a thread RNG — fresh per process for AA
and per *pixel* for light clouds, making its output nondeterministic. Here
the tables are drawn once per render from a seeded generator, which both
fixes determinism and removes a large amount of per-pixel host work.
"""

from __future__ import annotations

import numpy as np


def poisson_disk(
    dims,
    radius: float,
    k: int = 30,
    seed: int = 0,
    max_points: int | None = None,
) -> np.ndarray:
    """Bridson's algorithm in len(dims) dimensions over the box [0, dims]^d."""
    dims = np.asarray(dims, dtype=np.float64)
    nd = dims.shape[0]
    rng = np.random.default_rng(seed)

    cell = radius / np.sqrt(nd)
    grid_shape = np.maximum(np.ceil(dims / cell).astype(int), 1)
    grid = -np.ones(grid_shape, dtype=np.int64)

    def grid_idx(p):
        return tuple(np.minimum((p // cell).astype(int), grid_shape - 1))

    points = []
    active = []

    p0 = rng.random(nd) * dims
    points.append(p0)
    active.append(0)
    grid[grid_idx(p0)] = 0

    neighbor_offsets = np.array(
        np.meshgrid(*([np.arange(-2, 3)] * nd), indexing="ij")
    ).reshape(nd, -1).T

    while active and (max_points is None or len(points) < max_points):
        ai = rng.integers(len(active))
        base = points[active[ai]]
        placed = False
        for _ in range(k):
            # uniform in the spherical shell [r, 2r]
            direction = rng.normal(size=nd)
            norm = np.linalg.norm(direction)
            if norm == 0.0:
                continue
            direction /= norm
            dist = radius * (1.0 + rng.random())
            cand = base + direction * dist
            if np.any(cand < 0.0) or np.any(cand >= dims):
                continue
            ci = np.array(grid_idx(cand))
            ok = True
            for off in neighbor_offsets:
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
