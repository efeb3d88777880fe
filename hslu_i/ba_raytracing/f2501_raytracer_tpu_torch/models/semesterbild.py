"""The flagship "semesterbild" scene (ref src/main.rs:26-348 and the
byte-identical examples/semesterbild.rs): an OBJ text mesh, nine spheres
with mixed diffuse/metallic/transmissive materials, four bounded-plane
boxes, and five point lights.

The text mesh is loaded from the reference checkout's data directory when
`RAYTRACER_REF_DATA` names one (the same variable the JAX package reads);
otherwise a procedural block-letter stand-in with the same material is
generated so the scene stays renderable/benchmarkable everywhere.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import RenderConfig
from ..materials import Material, TransmissionProperties
from ..scene.builder import (
    BoundedPlane,
    Isometry3,
    Scene,
    Similarity3,
    SphereData,
    TriangleData,
    quat_rotate,
    rotor3_from_euler_angles,
)
from ..scene.lighting import PointLight

REF_DATA_ROOT = os.environ.get("RAYTRACER_REF_DATA", "")


def _text_obj_path(cfg: RenderConfig) -> str:
    # the reference picks the hq mesh when high_quality_model OR the
    # medium_resolution feature (1140x950) is set (ref src/main.rs:30-35);
    # the predicate is shared with the triangle-block auto-resolver
    # (config.py::uses_hq_mesh)
    name = "text.obj" if cfg.uses_hq_mesh else "text_lowres.obj"
    return os.path.join(REF_DATA_ROOT, "data", "obj", "text", name)


def _procedural_text_scene(transform: Similarity3) -> Scene:
    """Fallback mesh: a row of extruded boxes standing in for the text
    geometry (same default white-diffuse material as the OBJ loader)."""
    scene = Scene()
    mat = Material.diffuse((1.0, 1.0, 1.0))
    x = 0.0
    for k in range(8):
        w, h, d = 0.055, 0.12 + 0.02 * (k % 3), 0.05
        cx, cy, cz = x + w / 2, h / 2, 0.0
        for tri in _box_triangles((cx, cy, cz), (w, h, d), mat):
            v = [transform.transform_vec(np.asarray(p, np.float32)) for p in tri]
            scene.add_triangle(TriangleData.with_material(v[0], v[1], v[2], mat))
        x += w + 0.02
    return scene


def _box_triangles(center, size, mat):
    cx, cy, cz = center
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    corners = np.array(
        [
            [cx - sx, cy - sy, cz - sz],
            [cx + sx, cy - sy, cz - sz],
            [cx + sx, cy + sy, cz - sz],
            [cx - sx, cy + sy, cz - sz],
            [cx - sx, cy - sy, cz + sz],
            [cx + sx, cy - sy, cz + sz],
            [cx + sx, cy + sy, cz + sz],
            [cx - sx, cy + sy, cz + sz],
        ],
        dtype=np.float32,
    )
    faces = [
        (0, 2, 1), (0, 3, 2),  # front
        (4, 5, 6), (4, 6, 7),  # back
        (0, 1, 5), (0, 5, 4),  # bottom
        (3, 6, 2), (3, 7, 6),  # top
        (0, 4, 7), (0, 7, 3),  # left
        (1, 2, 6), (1, 6, 5),  # right
    ]
    return [(corners[a], corners[b], corners[c]) for a, b, c in faces]


def build_scene(cfg: RenderConfig) -> Scene:
    cam = cfg.camera
    W, H, D = cam.scene_width, cam.scene_height, cam.scene_depth
    AVG = cam.average_scene_dimension

    mesh_transform = Similarity3(
        translation=(0.0135 * W, 0.145 * H, 0.885 * D),
        rotation=rotor3_from_euler_angles(0.0, -0.015, 0.0),
        scale=1.226 * AVG,
    )

    obj_path = _text_obj_path(cfg)
    if REF_DATA_ROOT and os.path.exists(obj_path):
        scene = Scene.from_obj(obj_path, mesh_transform, continue_on_material_failure=True)
    else:
        scene = _procedural_text_scene(mesh_transform)

    # nine spheres (main.rs:48-148)
    spheres = [
        ((0.475 * W, 0.385 * H, 0.595 * D), 0.291 * AVG,
         Material.new((1.0, 0.8, 1.0), 0.0, 0.15, TransmissionProperties.new_with_boost(0.99, 1.5, 0.025))),
        ((0.8 * W, 0.76 * H, 0.2 * D), 0.07 * AVG,
         Material.new((0.75, 0.5, 1.0), 0.2, 0.3, TransmissionProperties.new(0.78, 1.5))),
        ((0.76 * W, 0.76 * H, 0.4 * D), 0.07 * AVG,
         Material.new((0.75, 0.9, 0.8), 0.2, 0.35, TransmissionProperties.new(0.6, 1.8))),
        ((0.73 * W, 0.7 * H, 0.52 * D), 0.065 * AVG,
         Material.new((0.75, 0.9, 0.8), 0.0, 0.7, TransmissionProperties.new(0.78, 1.3))),
        ((0.69 * W, 0.76 * H, 0.3 * D), 0.07 * AVG,
         Material.new((0.88, 0.9, 0.88), 0.0, 0.1, TransmissionProperties.new_with_boost(1.0, 1.42, 0.125))),
        ((0.1 * W, 0.68 * H, 0.3 * D), 0.07 * AVG,
         Material.new((0.88, 0.9, 0.88), 0.2, 0.7, TransmissionProperties.none())),
        ((0.35 * W, 0.76 * H, 0.25 * D), 0.07 * AVG,
         Material.new((0.9, 0.2, 0.3), 0.0, 0.01, TransmissionProperties.none())),
        ((0.2 * W, 0.87 * H, 0.5 * D), 0.07 * AVG,
         Material.new((0.88, 0.5, 0.7), 0.4, 0.2, TransmissionProperties.none())),
        ((0.5 * W, 0.87 * H, 0.46 * D), 0.075 * AVG,
         Material.new((1.0, 1.0, 1.0), 0.95, 0.23, TransmissionProperties.none())),
    ]
    for center, radius, mat in spheres:
        scene.add_sphere(SphereData.with_material(center, radius, mat))

    # four bounded planes under a shared rotation (main.rs:150-249)
    rotor = rotor3_from_euler_angles(-0.04, 0.125, 0.51)
    isometry = Isometry3(translation=(0.25 * W, 0.002 * H, 0.037 * D), rotation=rotor)

    def rot(v):
        return quat_rotate(rotor, np.asarray(v, np.float32))

    unit_x, unit_y, unit_z = (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)

    planes = [
        # back plane
        (-rot(unit_z),
         isometry.transform_vec((W * 0.5, (H * 1.1) * 0.5, D)),
         rot(unit_y), W, H * 1.1, 0.01 * D,
         Material.new((0.5, 0.75, 0.75), 0.0, 0.0, TransmissionProperties.none())),
        # translucent bottom plane
        (rot(unit_y),
         isometry.transform_vec((W * 0.5, H + 0.001, D * 0.5)),
         rot(unit_z), W, D, 0.012 * D,
         Material.new((0.75, 0.5, 0.75), 0.0, 0.7, TransmissionProperties.new(0.675, 1.13))),
        # opaque bottom plane below it
        (rot(unit_y),
         isometry.transform_vec((W * 0.5, H + 0.09, D * 0.5)),
         rot(unit_z), W, D, 0.01 * D,
         Material.new((0.75, 0.5, 0.75), 0.0, 0.7, TransmissionProperties.none())),
        # right plane
        (-rot(unit_x),
         isometry.transform_vec((W, (H * 1.1) * 0.5, D * 0.5)),
         -rot(unit_z), H * 1.1, D, 0.01 * D,
         Material.new((0.875, 0.85, 0.61), 0.55, 0.325, TransmissionProperties.none())),
    ]
    for normal, center, up, width, height, depth, mat in planes:
        for tri in BoundedPlane.with_material(normal, center, up, width, height, depth, mat).to_basic_geometries():
            scene.add_triangle(tri)

    # five point lights (main.rs:251-296)
    lights = [
        ((W / 1.2, 0.0, 0.015 * D), (0.825, 0.675, 0.5), 1.0),
        ((W / 2.4, H * 0.1, 0.08 * D), (0.825, 0.675, 0.65), 0.675),
        ((W, H, 0.01 * D), (0.825, 0.35, 0.8), 0.435),
        (tuple(isometry.transform_vec((W * 0.5, H + 0.05, D * 0.75))), (1.0, 1.0, 1.0), 0.2775),
        ((0.2 * W, H * 0.67, 0.95 * D), (0.825, 0.5, 0.7), 0.26),
    ]
    for pos, color, intensity in lights:
        scene.add_light(PointLight.new(pos, color, intensity))

    return scene
