"""Host-side scene graph: primitives, composites, collection, builder.

Mirrors ref src/geometry/ (sphere.rs, triangle.rs, composite/bounded_plane.rs,
render_geometry.rs) and src/scene/scene.rs, but as plain numpy-backed records
that later flatten into SoA device arrays (scene/device.py). Object ids are
sequential ints instead of the reference's random f32 tags
(ref geometry/mod.rs:30-50) — they serve the same identity role.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..materials import Material

_object_id_counter = itertools.count(1)


def _new_object_id() -> int:
    return next(_object_id_counter)


def _v(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


@dataclasses.dataclass
class SphereData:
    """ref geometry/basic/sphere.rs:20-48 — precomputes r^2 and 1/r."""

    center: np.ndarray
    radius: float
    material: Material
    object_id: int = dataclasses.field(default_factory=_new_object_id)

    def __post_init__(self):
        self.center = _v(self.center)
        self.radius = float(self.radius)

    @classmethod
    def new(cls, center, radius, color) -> "SphereData":
        return cls(_v(center), radius, Material.diffuse(color))

    @classmethod
    def with_material(cls, center, radius, material: Material) -> "SphereData":
        return cls(_v(center), radius, material)

    @property
    def r_sq(self) -> float:
        return self.radius * self.radius

    @property
    def r_inv(self) -> float:
        return 1.0 / self.radius


@dataclasses.dataclass
class TriangleData:
    """ref geometry/basic/triangle.rs:22-113 — stores vertices, edges and a
    (possibly supplied, possibly non-unit) face normal."""

    vertex1: np.ndarray
    vertex2: np.ndarray
    vertex3: np.ndarray
    normal: np.ndarray
    material: Material
    object_id: int = dataclasses.field(default_factory=_new_object_id)

    @classmethod
    def new(cls, v1, v2, v3, color) -> "TriangleData":
        return cls.with_material(v1, v2, v3, Material.diffuse(color))

    @classmethod
    def with_material(cls, v1, v2, v3, material: Material) -> "TriangleData":
        v1, v2, v3 = _v(v1), _v(v2), _v(v3)
        e1, e2 = v2 - v1, v3 - v1
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n)
        n = n / norm if norm > 0 else n
        return cls(v1, v2, v3, n.astype(np.float32), material)

    @classmethod
    def with_material_and_normal(cls, v1, v2, v3, normal, material: Material) -> "TriangleData":
        # NB: the supplied normal is NOT re-normalized (ref triangle.rs:81-102)
        return cls(_v(v1), _v(v2), _v(v3), _v(normal), material)

    @property
    def edge1(self) -> np.ndarray:
        return self.vertex2 - self.vertex1

    @property
    def edge2(self) -> np.ndarray:
        return self.vertex3 - self.vertex1

    def get_center(self) -> np.ndarray:
        return (self.vertex1 + self.vertex2 + self.vertex3) / np.float32(3.0)


class BoundedPlane:
    """Finite rectangular slab -> closed 12-triangle box
    (ref geometry/composite/bounded_plane.rs:14-216)."""

    def __init__(self, normal, center, up, width, height, depth, material: Material):
        normal, center, up = _v(normal), _v(center), _v(up)
        assert width > 0, "width must be positive"
        assert height > 0, "height must be positive"
        assert abs(float(np.dot(normal, up))) <= 1e-6, "up must be orthogonal to normal"
        self.normal = normal
        self.center = center
        self.up = up
        left = np.cross(normal, up)
        self.left = (left / np.linalg.norm(left)).astype(np.float32)
        self.width = float(width)
        self.height = float(height)
        self.depth = float(depth)
        self.material = material
        self.object_id = _new_object_id()

    @classmethod
    def with_material(cls, normal, center, up, width, height, depth, material):
        return cls(normal, center, up, width, height, depth, material)

    def triangulate(self) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]:
        """ref bounded_plane.rs:103-127."""
        x = (self.width / 2.0) * -self.left
        y = (self.height / 2.0) * self.up
        c = self.center
        p0, p1 = -x + y, x + y
        p2, p3 = -x - y, x - y
        return ((c + p1, c + p0, c + p3), (c + p2, c + p3, c + p0))

    def to_basic_geometries(self) -> List[TriangleData]:
        """ref bounded_plane.rs:145-216 — front+back plates plus 4 side
        plates, 12 triangles, outward normals, shared object id."""
        t1, t2 = self.triangulate()
        tris: List[TriangleData] = []
        dod = self.normal

        for depth_offset, normal in (
            (-(self.depth * 0.5), -self.normal),
            (self.depth * 0.5, self.normal),
        ):
            off = dod * np.float32(depth_offset)
            for tri in (t1, t2):
                t = TriangleData.with_material_and_normal(
                    tri[0] + off, tri[1] + off, tri[2] + off, normal, self.material
                )
                t.object_id = self.object_id
                tris.append(t)

        for direction, dir_offset, width, normal in (
            (self.up, self.height, self.width, self.up),
            (self.left, self.width, self.height, self.left),
            (-self.up, self.height, self.width, -self.up),
            (-self.left, self.width, self.height, -self.left),
        ):
            plate_center = direction * np.float32(dir_offset * 0.5) + self.center
            side = _SidePlate(normal, plate_center, dod, width, self.depth)
            for tri in side.triangulate():
                t = TriangleData.with_material_and_normal(
                    tri[0], tri[1], tri[2], normal, self.material
                )
                t.object_id = self.object_id
                tris.append(t)
        return tris


class _SidePlate:
    """Zero-depth helper plane used for side plates (the reference reuses
    BoundedPlane::with_material with depth=0, bounded_plane.rs:185-202)."""

    def __init__(self, normal, center, up, width, height):
        self.normal = _v(normal)
        self.center = _v(center)
        self.up = _v(up)
        left = np.cross(self.normal, self.up)
        self.left = (left / np.linalg.norm(left)).astype(np.float32)
        self.width = float(width)
        self.height = float(height)

    def triangulate(self):
        x = (self.width / 2.0) * -self.left
        y = (self.height / 2.0) * self.up
        c = self.center
        p0, p1 = -x + y, x + y
        p2, p3 = -x - y, x - y
        return ((c + p1, c + p0, c + p3), (c + p2, c + p3, c + p0))


class GeometryCollection:
    """Primitives grouped by kind (ref render_geometry.rs:99-155)."""

    def __init__(self):
        self.spheres: List[SphereData] = []
        self.triangles: List[TriangleData] = []

    def add(self, geometry):
        if isinstance(geometry, SphereData):
            self.spheres.append(geometry)
        elif isinstance(geometry, TriangleData):
            self.triangles.append(geometry)
        else:
            raise TypeError(f"unsupported geometry: {type(geometry)!r}")

    def get_all(self):
        return list(self.spheres) + list(self.triangles)

    def merge(self, other: "GeometryCollection"):
        self.spheres.extend(other.spheres)
        self.triangles.extend(other.triangles)

    def __len__(self):
        return len(self.spheres) + len(self.triangles)


class Scene:
    """Builder API (ref scene/scene.rs:23-179)."""

    def __init__(self):
        self.scene_objects = GeometryCollection()
        self.scene_lights: List = []

    def add_sphere(self, sphere: SphereData):
        self.scene_objects.add(sphere)

    def add_triangle(self, triangle: TriangleData):
        self.scene_objects.add(triangle)

    def add_geometry(self, geometry):
        self.scene_objects.add(geometry)

    def add_light(self, light):
        self.scene_lights.append(light)

    def merge(self, other: "Scene"):
        self.scene_objects.merge(other.scene_objects)
        self.scene_lights.extend(other.scene_lights)

    @staticmethod
    def backface_culling(scene: "Scene", view_direction) -> "Scene":
        """Static cull: drop opaque triangles whose normal is ~parallel to the
        view axis, |dot - 1| <= 0.01 (ref scene.rs:136-155)."""
        view = _v(view_direction)
        out = Scene()
        out.scene_lights = list(scene.scene_lights)
        for s in scene.scene_objects.spheres:
            out.add_sphere(s)
        for t in scene.scene_objects.triangles:
            if t.material.transmission.mask:
                out.add_triangle(t)
                continue
            if abs(float(np.dot(t.normal, view)) - 1.0) > 0.01:
                out.add_triangle(t)
        return out

    @classmethod
    def from_obj(
        cls,
        path,
        transform: Optional["Similarity3"] = None,
        continue_on_material_failure: bool = True,
    ) -> "Scene":
        from .obj_loader import load_obj_scene

        return load_obj_scene(path, transform, continue_on_material_failure)


@dataclasses.dataclass(frozen=True)
class Similarity3:
    """Minimal ultraviolet::Similarity3 stand-in: scale, then rotate
    (quaternion), then translate."""

    translation: Tuple[float, float, float]
    rotation: np.ndarray  # quaternion (w, x, y, z)
    scale: float

    def transform_vec(self, v: np.ndarray) -> np.ndarray:
        return quat_rotate(self.rotation, _v(v) * np.float32(self.scale)) + _v(self.translation)

    def rotate_vec(self, v: np.ndarray) -> np.ndarray:
        return quat_rotate(self.rotation, _v(v))


@dataclasses.dataclass(frozen=True)
class Isometry3:
    translation: Tuple[float, float, float]
    rotation: np.ndarray

    def transform_vec(self, v: np.ndarray) -> np.ndarray:
        return quat_rotate(self.rotation, _v(v)) + _v(self.translation)


def quat_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_rotate_batch(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate (N,3) vectors by quaternion (w,x,y,z)."""
    w, x, y, z = q
    u = np.array([x, y, z])
    v64 = np.asarray(v, dtype=np.float64)
    out = (
        2.0 * (v64 @ u)[:, None] * u[None, :]
        + (w * w - np.dot(u, u)) * v64
        + 2.0 * w * np.cross(np.broadcast_to(u, v64.shape), v64)
    )
    return out.astype(np.float32)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    u = np.array([x, y, z])
    v64 = np.asarray(v, dtype=np.float64)
    out = 2.0 * np.dot(u, v64) * u + (w * w - np.dot(u, u)) * v64 + 2.0 * w * np.cross(u, v64)
    return out.astype(np.float32)


def rotor3_from_euler_angles(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """ultraviolet Rotor3::from_euler_angles(roll, pitch, yaw):
    Rxy(roll) * Ryz(pitch) * Rxz(yaw) — i.e. yaw about -y first, then pitch
    about +x, then roll about +z (geometric-algebra plane rotations)."""
    q_roll = quat_axis_angle((0.0, 0.0, 1.0), roll)  # xy-plane
    q_pitch = quat_axis_angle((1.0, 0.0, 0.0), pitch)  # yz-plane
    q_yaw = quat_axis_angle((0.0, -1.0, 0.0), yaw)  # xz-plane
    return quat_mul(q_roll, quat_mul(q_pitch, q_yaw))
