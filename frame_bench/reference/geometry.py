"""Geometry preparation of the plain reference, from the raw scene: the
bounded planes cut into triangles, face normals of mesh triangles, the
static backface cull, and flat material tables.

Semantics (the reference renderer's, written out here anew):
* a bounded plane is a closed box of 12 triangles, its front and back plates
  offset by half the depth along -normal / +normal with those normals, and
  four side plates of zero depth with outward normals
  (ref geometry/composite/bounded_plane.rs:103-216); supplied normals are not
  renormalised;
* a mesh triangle's normal is normalize((v2 - v1) x (v3 - v1));
* the static cull drops opaque triangles whose normal lies within 0.01 of
  the view axis +z, |n.z - 1| <= 0.01 (ref scene/scene.rs:136-155).
"""

from __future__ import annotations

import numpy as np

F32_EPS = float(2.0**-23)


def _plate(center, normal, up, width, height):
    """The two triangles of a rectangle (ref bounded_plane.rs:103-127)."""
    left = np.cross(normal, up)
    left = left / np.linalg.norm(left)
    x = (width / 2.0) * -left
    y = (height / 2.0) * up
    p0, p1, p2, p3 = -x + y, x + y, -x - y, x - y
    return [(center + p1, center + p0, center + p3), (center + p2, center + p3, center + p0)]


def plane_triangles(pl):
    """[(vertices (3, 3), normal (3,))] of one bounded plane."""
    n = np.asarray(pl["normal"], np.float64)
    c = np.asarray(pl["center"], np.float64)
    up = np.asarray(pl["up"], np.float64)
    w, h, d = pl["width"], pl["height"], pl["depth"]
    left = np.cross(n, up)
    left = left / np.linalg.norm(left)
    out = []
    for off, normal in ((-d * 0.5, -n), (d * 0.5, n)):
        for tri in _plate(c, n, up, w, h):
            out.append((np.stack(tri) + n * off, normal))
    for direction, extent, width in ((up, h, w), (left, w, h), (-up, h, w), (-left, w, h)):
        centre = direction * (extent * 0.5) + c
        for tri in _plate(centre, direction, n, width, d):
            out.append((np.stack(tri), direction))
    return out


def _mat_row(m):
    """(colour r, g, b, metallic, shininess, ior, opacity, transmissive, boost)."""
    trans = m["opacity"] is not None and abs(m["opacity"]) > F32_EPS
    return [*m["color"], m["metallic"], m["shininess"], m["ior"],
            m["opacity"] if trans else 0.0, 1.0 if trans else 0.0, m["boost"]]


def prepare(raw: dict, static_cull: bool):
    """Flat float64 tables: spheres (S, 4) centre and radius, sphere
    materials (S, 9), triangles (T, 3, 3), normals (T, 3), triangle
    materials (T, 9)."""
    tris = []
    for t in raw["triangles"]:
        v = np.asarray(t["vertices"], np.float64)
        n = np.cross(v[1] - v[0], v[2] - v[0])
        nn = np.linalg.norm(n)
        tris.append((v, n / nn if nn > 0 else n, t["material"]))
    for pl in raw["planes"]:
        tris.extend((v, n, pl["material"]) for v, n in plane_triangles(pl))
    if static_cull:
        tris = [t for t in tris
                if _mat_row(t[2])[7] or abs(float(t[1][2]) - 1.0) > 0.01]
    sph = raw["spheres"]
    return dict(
        sph=np.array([[*s["center"], s["radius"]] for s in sph], np.float64).reshape(-1, 4),
        sph_mat=np.array([_mat_row(s["material"]) for s in sph], np.float64).reshape(-1, 9),
        tri=np.stack([t[0] for t in tris]).astype(np.float64),
        tri_n=np.stack([t[1] for t in tris]).astype(np.float64),
        tri_mat=np.array([_mat_row(t[2]) for t in tris], np.float64),
    )
