"""Lights: point lights, ambient light, soft-shadow light clouds.

Mirrors ref src/scene/lighting/light.rs. Light colors are value-maximized on
construction (light.rs:96/178). Soft shadows replace each point light with N
Poisson-jittered lights at 1/N intensity (light.rs:183-226); the reference
re-draws that cloud per *pixel* from a thread RNG — here the cloud is drawn
once per render from a seeded generator (deterministic, and the per-pixel
variance the reference exhibits averages to the same penumbra).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import CameraSpec
from ..ops.colorops import maximize_value
from ..ops.sampling import poisson_disk


@dataclasses.dataclass
class PointLight:
    """ref light.rs:161-226."""

    position: np.ndarray
    color: np.ndarray  # value-maximized linear RGB
    intensity: float

    @classmethod
    def new(cls, position, color, intensity) -> "PointLight":
        return cls(
            np.asarray(position, dtype=np.float32),
            maximize_value(np.asarray(color, dtype=np.float32)),
            float(intensity),
        )

    def to_point_light_cloud(
        self, n: int, camera: CameraSpec, rng: np.random.Generator
    ) -> List["PointLight"]:
        """ref light.rs:183-226. Offsets live in [0, cloud_radius)^3 window
        units, scaled componentwise by the window->scene factors."""
        if n == 1:
            return [self]
        cloud_radius = 1.725 + n / 20.0
        scale = 1.0 / n
        w2s = np.array(
            [camera.w2s_width, camera.w2s_height, camera.w2s_depth], dtype=np.float32
        )
        pts = poisson_disk(
            [cloud_radius] * 3,
            radius=4.0 / n,
            k=n,
            seed=int(rng.integers(0, 2**31 - 1)),
            max_points=n,
        )
        if pts.shape[0] < n:  # pad with uniform random points (light.rs:213)
            pad = rng.random((n - pts.shape[0], 3), dtype=np.float32) * cloud_radius
            pts = np.concatenate([pts, pad], axis=0)
        out = []
        for k in range(n):
            out.append(
                PointLight(
                    self.position + pts[k] * w2s,
                    self.color,
                    self.intensity * scale,
                )
            )
        return out


@dataclasses.dataclass
class AmbientLight:
    """ref light.rs:80-159. The shading loop uses only color*intensity
    (raytracer_renderer.rs:752-764); `calculate_contribution_at`'s
    incident-angle rescale (cos+1)/2.75 exists but is not on the render path."""

    color: np.ndarray
    intensity: float

    @classmethod
    def new(cls, color, intensity) -> "AmbientLight":
        return cls(maximize_value(np.asarray(color, dtype=np.float32)), float(intensity))

    def contribution_at(self, material_color, normal, ray_from_direction):
        """Parity port of ref light.rs:132-158 (not on the hot path)."""
        cos = -np.dot(ray_from_direction, normal)
        rescaled = (cos + 1.0) / 2.75
        return material_color * self.color, rescaled * self.intensity, cos > 0.0


# SceneLightSource in the reference is an enum with a single PointLight
# variant (light.rs:302-325); a plain PointLight plays that role here.
SceneLightSource = PointLight


def preprocess_lights(
    lights: List[PointLight],
    multiplicator: int,
    camera: CameraSpec,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand lights into a cloud (ref SceneLightSource::preprocess,
    light.rs:311-325) and flatten to SoA arrays: pos (L,3), color (L,3),
    intensity (L,)."""
    rng = np.random.default_rng(seed + 0x51DE)
    flat: List[PointLight] = []
    for light in lights:
        flat.extend(light.to_point_light_cloud(multiplicator, camera, rng))
    if not flat:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32),
            np.zeros((0,), np.float32),
        )
    pos = np.stack([l.position for l in flat]).astype(np.float32)
    col = np.stack([l.color for l in flat]).astype(np.float32)
    inten = np.array([l.intensity for l in flat], dtype=np.float32)
    return pos, col, inten
