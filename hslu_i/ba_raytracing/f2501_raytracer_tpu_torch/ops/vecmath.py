"""Small 3D vector helpers over `(..., 3)` tensors.

The port's copy of the JAX package's `ops/vecmath.py`: a wavefront of N
rays is a tensor with a leading ray axis, so only the handful of geometric
operations of the reference remain. Semantics match ultraviolet's Vec3 ops
used by the reference: `reflected` (vector.rs:306-312), `refracted`
(vector.rs:335-341, GLSL refract), `normalized`; and the `Ray` record
(geometry/ray.rs).
"""

from __future__ import annotations

import dataclasses

import torch

F32_EPSILON = float(2.0**-23)  # approx::AbsDiffEq default epsilon for f32


def dot(a, b):
    """Left-to-right sum of the three products: the order of a sequential
    reduce (XLA's) and of the CUDA kernels' scalar code."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def mag(a):
    return torch.sqrt(dot(a, a))


def normalized(a):
    """ultraviolet `normalized`: multiply by 1/sqrt(mag_sq); 0-vectors ->
    non-finite."""
    return a * torch.reciprocal(torch.sqrt(dot(a, a)))[..., None]


def reflected(v, n):
    """ultraviolet reflect: v - 2*(v.n)*n."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refracted(i, n, eta):
    """GLSL-style refract (ultraviolet `refracted`).

    k = 1 - eta^2 (1 - (n.i)^2); returns the 0-vector where k < 0 (the
    reference then normalizes it into NaN and the resulting ray never hits
    anything -- callers mask with the returned `valid`).
    """
    ndi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    k_pos = k >= 0.0
    k_safe = torch.clamp(k, min=0.0)
    out = i * eta[..., None] - (eta * ndi + torch.sqrt(k_safe))[..., None] * n
    return torch.where(k_pos[..., None], out, torch.zeros_like(out)), k_pos


def lerp(a, b, t):
    return a + (b - a) * t


@dataclasses.dataclass(frozen=True)
class Ray:
    """Wavefront ray record (ref geometry/ray.rs:9-18): origins, normalized
    directions, the refraction index of the current medium, and per-ray
    validity. The invalid-lane sentinel is +inf (ray.rs:77-94)."""

    origin: torch.Tensor  # (R, 3)
    direction: torch.Tensor  # (R, 3), normalized on construction
    refraction_index: torch.Tensor  # (R,)
    valid_mask: torch.Tensor  # (R,) bool

    @classmethod
    def new(cls, origin, direction, refraction_index, valid_mask=None):
        direction = normalized(direction)
        if valid_mask is None:
            valid_mask = torch.ones(origin.shape[:-1], dtype=torch.bool, device=origin.device)
        return cls(origin, direction, refraction_index, valid_mask)

    def at(self, t):
        """dir*t + origin (ray.rs:60-66)."""
        return self.direction * t[..., None] + self.origin

    @staticmethod
    def invalid_value():
        return float("inf")
