"""Seeded clouds of small triangles: synthetic scenes past
`cfg.stream_triangles`, where `build_device_scene` sets `streaming`.

`add_triangle_cloud` is the generator of the streaming validation scene
(centres uniform in a box, edges drawn from N(0, edge_sigma), drawn in that
order from one `default_rng(seed)`); `build_scene` puts such a cloud, a share
of it glass, into the semesterbild scene box, so a frame has spheres, big
primitives, lights and a streamed mesh at once.
"""

from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..materials import Material, TransmissionProperties
from ..scene.builder import Scene, TriangleData
from . import semesterbild

MATTE = Material((0.5, 0.5, 0.5), 0.0, 0.2)
GLASS = Material.new((0.9, 0.95, 1.0), 0.0, 0.2, TransmissionProperties.new(0.35, 1.5))


def add_triangle_cloud(scene: Scene, n: int, lo, hi, edge_sigma: float, seed: int,
                       glass_share: float = 0.0) -> None:
    """Add n triangles (c, c + e1, c + e2) to `scene`: c uniform in the box
    [lo, hi], e1 and e2 normal with deviation `edge_sigma`. The triangles
    whose centre lies in the first `glass_share` of the box along x are
    GLASS, the rest MATTE: the glass is in one place, so after the Morton
    sort some blocks hold transmissive triangles and most hold none."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    c = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, edge_sigma, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, edge_sigma, (n, 3)).astype(np.float32)
    glass = c[:, 0] < lo[0] + glass_share * (hi[0] - lo[0])
    v2, v3 = c + e1, c + e2
    normal = np.cross(v2 - c, v3 - c)
    norm = np.linalg.norm(normal, axis=1, keepdims=True)
    normal = np.where(norm > 0, normal / np.where(norm > 0, norm, 1), normal).astype(np.float32)
    for i in range(n):
        scene.add_triangle(
            TriangleData(c[i], v2[i], v3[i], normal[i], GLASS if glass[i] else MATTE))


def build_scene(cfg: RenderConfig, n: int = 120_000, edge_sigma: float = 0.0022,
                glass_share: float = 0.1, seed: int = 7) -> Scene:
    """semesterbild plus a cloud of n small triangles inside the scene box
    (between the camera plane and the back wall). The defaults give a cloud
    past the default `stream_triangles` that covers part of the frame."""
    cam = cfg.camera
    W, H, D = cam.scene_width, cam.scene_height, cam.scene_depth
    scene = semesterbild.build_scene(cfg)
    add_triangle_cloud(scene, n, (0.02 * W, 0.02 * H, 0.05 * D), (0.98 * W, 0.9 * H, 0.8 * D),
                       edge_sigma, seed, glass_share)
    return scene
