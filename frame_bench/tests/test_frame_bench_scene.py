"""The seeded scene: seed 0 is the reference's scene as the port's model
builds it, other seeds keep every count, are deterministic, and move nothing
into anything else or out of view."""

import numpy as np
import pytest

import fb_util  # noqa: F401 (paths)
from framebench import port, spec
from reference.geometry import plane_triangles

W, H, BOUND = 1920, 1080, 0.0004


def _scene_arrays(s):
    objs = s.scene_objects
    return dict(
        sph=[(sp.center, sp.radius, sp.material) for sp in objs.spheres],
        tri=[(t.vertex1, t.vertex2, t.vertex3, t.normal, t.material) for t in objs.triangles],
        lights=[(lt.position, lt.color, lt.intensity) for lt in s.scene_lights],
    )


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_seed_zero_is_the_ports_semesterbild():
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import semesterbild

    raw = spec.scene_module("semesterbild").build(W, H, 0, BOUND)
    got = _scene_arrays(port.scene(raw))
    want = _scene_arrays(semesterbild.build_scene(RenderConfig(width=W, height=H)))
    for key in ("sph", "tri", "lights"):
        assert _same(got[key], want[key]), key


@pytest.mark.parametrize("seed", [1, 77, 2**31 + 9])
def test_seeds_keep_counts_and_repeat(seed):
    mod = spec.scene_module("semesterbild")
    base, a, b = mod.build(W, H, 0, BOUND), mod.build(W, H, seed, BOUND), mod.build(W, H, seed, BOUND)
    for key in ("triangles", "spheres", "planes", "lights"):
        assert len(a[key]) == len(base[key])
    assert all(np.array_equal(x["center"], y["center"]) for x, y in zip(a["spheres"], b["spheres"]))
    moved = np.stack([s["center"] for s in a["spheres"]]) - np.stack([s["center"] for s in base["spheres"]])
    lmoved = np.stack([lt["position"] for lt in a["lights"]]) - np.stack(
        [lt["position"] for lt in base["lights"]])
    assert np.abs(moved).max() <= BOUND and np.abs(lmoved).max() <= BOUND
    assert np.abs(moved).max() > 0 and np.abs(lmoved).max() > 0
    assert [s["material"] for s in a["spheres"]] == [s["material"] for s in base["spheres"]]


def _point_triangle_distance(p, tri):
    """Distance from p to a triangle (3, 3), by the closest point."""
    a, b, c = tri
    ab, ac = b - a, c - a
    n = np.cross(ab, ac)
    n = n / np.linalg.norm(n)
    q = p - np.dot(p - a, n) * n
    # inside test by barycentrics, else the nearest edge
    v0, v1, v2 = ab, ac, q - a
    d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
    d20, d21 = v2 @ v0, v2 @ v1
    den = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    if v >= 0 and w >= 0 and v + w <= 1:
        return float(np.linalg.norm(p - q))

    def seg(p, x, y):
        t = np.clip(np.dot(p - x, y - x) / np.dot(y - x, y - x), 0, 1)
        return np.linalg.norm(p - (x + t * (y - x)))

    return float(min(seg(p, a, b), seg(p, b, c), seg(p, c, a)))


def test_offset_bound_moves_nothing_into_anything():
    """With every sphere and light moved by up to the bound in each axis
    (|offset| <= sqrt(3) * bound), every sphere that is apart from another
    sphere or a triangle in the reference's scene stays apart, every one
    that overlaps it keeps overlapping, no light comes inside an object,
    and every sphere's centre stays in view."""
    raw = spec.scene_module("semesterbild").build(W, H, 0, BOUND)
    reach = np.sqrt(3) * BOUND
    tris = [np.asarray(t["vertices"], np.float64) for t in raw["triangles"]]
    for pl in raw["planes"]:
        tris += [v for v, _ in plane_triangles(pl)]
    sph = [(np.asarray(s["center"], np.float64), s["radius"]) for s in raw["spheres"]]
    for i, (c, r) in enumerate(sph):
        for c2, r2 in sph[i + 1:]:
            assert abs(np.linalg.norm(c - c2) - r - r2) > 2 * reach
        assert min(abs(_point_triangle_distance(c, t) - r) for t in tris) > reach
    for lt in raw["lights"]:
        p = np.asarray(lt["position"], np.float64)
        assert all(np.linalg.norm(p - c) - r > 2 * reach for c, r in sph)
        assert min(_point_triangle_distance(p, t) for t in tris) > reach
    aspect, depth = H / W, (1 + H / W) / 2
    focus = np.array([0.5, aspect / 2, -1.9 * depth])
    for c, _ in sph:
        for off in (np.full(3, -reach), np.full(3, reach)):
            q = c + off
            s = -focus[2] / (q[2] - focus[2])  # the image plane z = 0
            x, y = focus[:2] + s * (q[:2] - focus[:2])
            assert 0.0 <= x <= 1.0 and 0.0 <= y <= aspect
