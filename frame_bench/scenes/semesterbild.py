"""The semesterbild scene as raw data, moved by a seed.

A frozen copy of the reference's scene definition (ref src/main.rs:26-348,
as the port's `models/semesterbild.py` transcribes it): the procedural
stand-in for the text mesh (the reference's OBJ mesh is not in the
repository), nine spheres, four bounded-plane boxes and five point lights.
It imports nothing of the port or of the JAX package: the harness hands the
same raw records to the port (through its `Scene` builder API) and to the
plain reference, which each derive their own triangles, light clouds and
culling from them.

`build(width, height, seed, offset_bound)` moves every sphere centre and
every light by a seeded offset, uniform in [-offset_bound, offset_bound]^3
scene units; seed 0 moves nothing, so its frame is the reference's scene.

Raw records: a material is a dict (color, metallic, shininess, opacity
(None = no transmission), ior, boost); `triangles` are the stand-in's
(vertices (3, 3) float32, material), their normal left to the builder;
`planes` are BoundedPlane arguments; lights are (position, colour before
value-maximising, intensity).
"""

from __future__ import annotations

import numpy as np


def _material(color, metallic=0.0, shininess=0.0, opacity=None, ior=1.0, boost=0.0):
    return dict(color=tuple(float(c) for c in color), metallic=float(metallic),
                shininess=float(shininess), opacity=opacity, ior=float(ior),
                boost=float(boost))


def _trans(opacity, ior, boost=0.0):
    return dict(opacity=opacity, ior=ior, boost=boost)


# TransmissionProperties::none() zeroes the refraction index (material.rs:36-42)
_OPAQUE = dict(opacity=None, ior=0.0, boost=0.0)


def _quat_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_rotate(q, v):
    """Rotate v by the quaternion (w, x, y, z): float64 math, float32 out."""
    w, x, y, z = q
    u = np.array([x, y, z])
    v64 = np.asarray(v, dtype=np.float64)
    out = 2.0 * np.dot(u, v64) * u + (w * w - np.dot(u, u)) * v64 + 2.0 * w * np.cross(u, v64)
    return out.astype(np.float32)


def rotor_from_euler(roll, pitch, yaw):
    """ultraviolet Rotor3::from_euler_angles: roll about +z, pitch about
    +x, yaw about -y, applied yaw first."""
    return _quat_mul(_quat_axis_angle((0.0, 0.0, 1.0), roll),
                     _quat_mul(_quat_axis_angle((1.0, 0.0, 0.0), pitch),
                               _quat_axis_angle((0.0, -1.0, 0.0), yaw)))


def _f32(v):
    return np.asarray(v, dtype=np.float32)


def camera(width, height):
    """Scene units of the reference's camera (ref src/lib.rs:73-92)."""
    aspect = float(height) / float(width)
    w, h = 1.0, aspect
    d = (w + h) / 2.0
    return dict(W=w, H=h, D=d, AVG=(w + h + d) / 3.0)


def _box_triangles(center, size):
    cx, cy, cz = center
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    c = np.array([
        [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
        [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
        [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
        [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
    ], dtype=np.float32)
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
             (3, 6, 2), (3, 7, 6), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    return [(c[a], c[b], c[k]) for a, b, k in faces]


def _text_stand_in(cam):
    """Eight extruded boxes under the text mesh's transform (scale, then
    rotate, then translate), white diffuse as the OBJ loader's default."""
    W, H, D, AVG = cam["W"], cam["H"], cam["D"], cam["AVG"]
    translation = _f32((0.0135 * W, 0.145 * H, 0.885 * D))
    rotation = rotor_from_euler(0.0, -0.015, 0.0)
    scale = np.float32(1.226 * AVG)
    mat = _material((1.0, 1.0, 1.0))
    tris, x = [], 0.0
    for k in range(8):
        w, h, d = 0.055, 0.12 + 0.02 * (k % 3), 0.05
        for tri in _box_triangles((x + w / 2, h / 2, 0.0), (w, h, d)):
            v = np.stack([quat_rotate(rotation, _f32(p) * scale) + translation for p in tri])
            tris.append(dict(vertices=v, material=mat))
        x += w + 0.02
    return tris


def build(width: int, height: int, seed: int, offset_bound: float) -> dict:
    cam = camera(width, height)
    W, H, D, AVG = cam["W"], cam["H"], cam["D"], cam["AVG"]

    spheres = [  # main.rs:48-148
        ((0.475 * W, 0.385 * H, 0.595 * D), 0.291 * AVG,
         _material((1.0, 0.8, 1.0), 0.0, 0.15, **_trans(0.99, 1.5, 0.025))),
        ((0.8 * W, 0.76 * H, 0.2 * D), 0.07 * AVG,
         _material((0.75, 0.5, 1.0), 0.2, 0.3, **_trans(0.78, 1.5))),
        ((0.76 * W, 0.76 * H, 0.4 * D), 0.07 * AVG,
         _material((0.75, 0.9, 0.8), 0.2, 0.35, **_trans(0.6, 1.8))),
        ((0.73 * W, 0.7 * H, 0.52 * D), 0.065 * AVG,
         _material((0.75, 0.9, 0.8), 0.0, 0.7, **_trans(0.78, 1.3))),
        ((0.69 * W, 0.76 * H, 0.3 * D), 0.07 * AVG,
         _material((0.88, 0.9, 0.88), 0.0, 0.1, **_trans(1.0, 1.42, 0.125))),
        ((0.1 * W, 0.68 * H, 0.3 * D), 0.07 * AVG,
         _material((0.88, 0.9, 0.88), 0.2, 0.7, **_OPAQUE)),
        ((0.35 * W, 0.76 * H, 0.25 * D), 0.07 * AVG,
         _material((0.9, 0.2, 0.3), 0.0, 0.01, **_OPAQUE)),
        ((0.2 * W, 0.87 * H, 0.5 * D), 0.07 * AVG,
         _material((0.88, 0.5, 0.7), 0.4, 0.2, **_OPAQUE)),
        ((0.5 * W, 0.87 * H, 0.46 * D), 0.075 * AVG,
         _material((1.0, 1.0, 1.0), 0.95, 0.23, **_OPAQUE)),
    ]

    rotor = rotor_from_euler(-0.04, 0.125, 0.51)  # main.rs:150-249
    iso_t = _f32((0.25 * W, 0.002 * H, 0.037 * D))

    def iso(v):
        return quat_rotate(rotor, _f32(v)) + iso_t

    def rot(v):
        return quat_rotate(rotor, _f32(v))

    ux, uy, uz = (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
    planes = [
        (-rot(uz), iso((W * 0.5, (H * 1.1) * 0.5, D)), rot(uy), W, H * 1.1, 0.01 * D,
         _material((0.5, 0.75, 0.75), 0.0, 0.0, **_OPAQUE)),
        (rot(uy), iso((W * 0.5, H + 0.001, D * 0.5)), rot(uz), W, D, 0.012 * D,
         _material((0.75, 0.5, 0.75), 0.0, 0.7, **_trans(0.675, 1.13))),
        (rot(uy), iso((W * 0.5, H + 0.09, D * 0.5)), rot(uz), W, D, 0.01 * D,
         _material((0.75, 0.5, 0.75), 0.0, 0.7, **_OPAQUE)),
        (-rot(ux), iso((W, (H * 1.1) * 0.5, D * 0.5)), -rot(uz), H * 1.1, D, 0.01 * D,
         _material((0.875, 0.85, 0.61), 0.55, 0.325, **_OPAQUE)),
    ]

    lights = [  # main.rs:251-296
        ((W / 1.2, 0.0, 0.015 * D), (0.825, 0.675, 0.5), 1.0),
        ((W / 2.4, H * 0.1, 0.08 * D), (0.825, 0.675, 0.65), 0.675),
        ((W, H, 0.01 * D), (0.825, 0.35, 0.8), 0.435),
        (tuple(iso((W * 0.5, H + 0.05, D * 0.75))), (1.0, 1.0, 1.0), 0.2775),
        ((0.2 * W, H * 0.67, 0.95 * D), (0.825, 0.5, 0.7), 0.26),
    ]

    sph_off = np.zeros((len(spheres), 3), np.float32)
    light_off = np.zeros((len(lights), 3), np.float32)
    if seed:
        rng = np.random.default_rng([int(seed), 0x5E3E])
        sph_off = rng.uniform(-offset_bound, offset_bound, sph_off.shape).astype(np.float32)
        light_off = rng.uniform(-offset_bound, offset_bound, light_off.shape).astype(np.float32)

    return dict(
        triangles=_text_stand_in(cam),
        spheres=[dict(center=_f32(c) + off, radius=float(r), material=m)
                 for (c, r, m), off in zip(spheres, sph_off)],
        planes=[dict(normal=_f32(n), center=_f32(c), up=_f32(u), width=float(w),
                     height=float(h), depth=float(d), material=m)
                for n, c, u, w, h, d, m in planes],
        lights=[dict(position=_f32(p) + off, color=tuple(float(x) for x in col),
                     intensity=float(i))
                for (p, col, i), off in zip(lights, light_off)],
    )
