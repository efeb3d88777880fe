"""Host-side material model (ref: src/raytracing/material.rs).

`Material` / `TransmissionProperties` mirror the reference's fields and the
`mask()` presence rule (opacity set AND |opacity| > f32 epsilon,
ref material.rs:44-50). The device pipeline flattens these into SoA arrays;
the Fresnel math lives in ops/shading.py.

The reference's Cook-Torrance `bsdf`/`brdf`/`btdf` (material.rs:248-465) is
dead code with no call sites and is deliberately not rebuilt (SURVEY §2.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

F32_EPSILON = float(2.0**-23)


@dataclasses.dataclass(frozen=True)
class TransmissionProperties:
    """ref material.rs:15-64."""

    refraction_index: float = 1.0
    opacity: Optional[float] = None  # None == SimdOption::none()
    boost: float = 0.0

    @classmethod
    def new(cls, opacity: float, refraction_index: float) -> "TransmissionProperties":
        return cls(refraction_index=refraction_index, opacity=opacity, boost=0.0)

    @classmethod
    def new_with_boost(
        cls, opacity: float, refraction_index: float, boost: float
    ) -> "TransmissionProperties":
        return cls(refraction_index=refraction_index, opacity=opacity, boost=boost)

    @classmethod
    def none(cls) -> "TransmissionProperties":
        # NB: the reference's none() zeroes the refraction index (material.rs:36-42)
        return cls(refraction_index=0.0, opacity=None, boost=0.0)

    @property
    def mask(self) -> bool:
        # ref material.rs:44-50: opacity present and not ~0
        return self.opacity is not None and abs(self.opacity) > F32_EPSILON


@dataclasses.dataclass(frozen=True)
class Material:
    """ref material.rs:77-94. `shininess` in [0,1]; the renderer raises it to
    the Phong exponent via shininess*512 (ref raytracer_renderer.rs:826)."""

    color: Tuple[float, float, float]
    metallic: float = 0.0
    shininess: float = 0.0
    # default is TransmissionProperties::default() (ior=1, opacity unset),
    # ref material.rs:66-74 / 128-138
    transmission: TransmissionProperties = dataclasses.field(
        default_factory=TransmissionProperties
    )

    @classmethod
    def new(cls, color, metallic, shininess, transmission) -> "Material":
        return cls(tuple(float(c) for c in color), float(metallic), float(shininess), transmission)

    @classmethod
    def diffuse(cls, color) -> "Material":
        return cls(tuple(float(c) for c in color))

    @classmethod
    def translucent(cls, color, opacity, refraction_index) -> "Material":
        return cls(
            tuple(float(c) for c in color),
            transmission=TransmissionProperties.new(opacity, refraction_index),
        )

    def absorption(self) -> np.ndarray:
        """ref material.rs:213-231: color premultiplied by (1 - clamp(opacity, 0, 1-eps));
        opacity defaults to 1 when unset (opaque -> ~zero absorption)."""
        op = self.transmission.opacity if self.transmission.mask else 1.0
        op = min(max(op, 0.0), 1.0 - F32_EPSILON)
        return np.asarray(self.color, dtype=np.float32) * (1.0 - op)


def material_from_mtl(mtl: dict) -> Material:
    """tobj::Material -> Material mapping (ref material.rs:96-126).

    diffuse `Kd` -> color; nonstandard `Pm`/`Ps` params -> metallic/shininess
    gated by the illumination model (Pm only for illum 3; Ps for illum 0/2/3).
    """
    illum = int(mtl.get("illum", 0))
    color = tuple(mtl.get("Kd", (0.0, 0.0, 0.0)))

    def _parse(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return 0.0

    metallic = _parse(mtl.get("Pm", "0.0")) if illum == 3 else 0.0
    shininess = _parse(mtl.get("Ps", "0.0")) if illum in (0, 2, 3) else 0.0
    return Material(color, metallic, shininess, TransmissionProperties())
