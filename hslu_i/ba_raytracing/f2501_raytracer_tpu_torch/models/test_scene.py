"""The "test_scene" example (ref examples/test_scene.rs:22-343): four
spheres, three free triangles, seven bounded planes (two tilted, five walls)
and six point lights."""

from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..materials import Material, TransmissionProperties
from ..scene.builder import (
    BoundedPlane,
    Scene,
    SphereData,
    TriangleData,
    quat_axis_angle,
    quat_rotate,
)
from ..scene.lighting import PointLight


def build_scene(cfg: RenderConfig) -> Scene:
    cam = cfg.camera
    W, H, D = cam.scene_width, cam.scene_height, cam.scene_depth
    scene = Scene()

    scene.add_sphere(
        SphereData.new((W / 2.5, H / 2.75, 0.170 * D), 0.070 * D, (1.0, 0.0, 0.0))
    )
    scene.add_sphere(
        SphereData.with_material(
            (W / 2.5, H / 1.5, 0.170 * D), 0.070 * D,
            Material.new((1.0, 0.0, 0.0), 0.8, 0.0, TransmissionProperties.none()),
        )
    )
    scene.add_sphere(
        SphereData.with_material(
            (1.9 * (W / 2.5), H / 2.8, 0.160 * D), 0.088 * D,
            Material.new((250 / 255, 1.0, 245 / 255), 0.01, 0.2, TransmissionProperties.new(0.85, 1.5)),
        )
    )
    scene.add_sphere(
        SphereData.with_material(
            (W / 2.5, 2.1 * (H / 2.5), 0.5 * D), 0.250 * D,
            Material.new((254 / 255, 1.0, 1.0), 0.5, 0.05, TransmissionProperties.none()),
        )
    )

    scene.add_triangle(
        TriangleData.with_material(
            (W * 0.05, H * 0.2, 0.2 * D), (W * 0.3, H * 0.5, 0.2 * D), (W * 0.25, H * 0.15, 0.15 * D),
            Material.new((0.5, 0.7, 0.8), 0.001, 0.2, TransmissionProperties.new(0.999, 1.8)),
        )
    )
    scene.add_triangle(
        TriangleData.with_material(
            (W * 0.55, H * 0.45, 0.2 * D), (W * 0.7, H * 0.72, 0.2 * D), (W * 0.65, H * 0.35, 0.14 * D),
            Material.new((0.7, 0.7, 0.8), 0.1, 0.3, TransmissionProperties.none()),
        )
    )
    scene.add_triangle(
        TriangleData.with_material(
            (W * 0.7, H * 0.90, 0.2 * D), (W * 0.55, H * 0.65, 0.2 * D), (W * 0.65, H * 0.55, 0.14 * D),
            Material.new((0.7, 0.7, 0.8), 0.1, 0.3, TransmissionProperties.new(1.0, 1.5)),
        )
    )

    # tilted plane 1: rotation in the yz plane (about +x) by -0.555
    q_yz = quat_axis_angle((1.0, 0.0, 0.0), -0.555)
    normal = quat_rotate(q_yz, np.float32([0.0, 0.0, -1.0]))
    up = quat_rotate(q_yz, np.float32([0.0, 1.0, 0.0]))
    for tri in BoundedPlane.with_material(
        normal, (W * 0.5, H * 0.45, 0.270 * D), up, W * 0.55, H * 0.55, 0.01 * D,
        Material.new((0.6, 0.7, 0.5), 0.075, 0.07, TransmissionProperties.new_with_boost(1.0, 1.5, 0.5)),
    ).to_basic_geometries():
        scene.add_triangle(tri)

    # tilted plane 2: rotation in the xz plane (about -y) by -0.9955
    q_xz = quat_axis_angle((0.0, -1.0, 0.0), -0.9955)
    normal = quat_rotate(q_xz, np.float32([0.0, 0.0, -1.0]))
    up = quat_rotate(q_xz, np.float32([0.0, 1.0, 0.0]))
    for tri in BoundedPlane.with_material(
        normal, (W * 0.82, H * 0.57, 0.110 * D), up, W * 0.318, H * 0.35, 0.007 * D,
        Material.new((0.99, 0.99, 0.99), 1.0, 0.2, TransmissionProperties.none()),
    ).to_basic_geometries():
        scene.add_triangle(tri)

    walls = [
        ((0.0, 0.0, -1.0), (W * 0.5, H * 0.5, D), (0.0, 1.0, 0.0), W, H, (0.5, 0.75, 0.75)),
        ((0.0, 1.0, 0.0), (W * 0.5, H, D * 0.5), (0.0, 0.0, 1.0), W, D, (0.75, 0.5, 0.75)),
        ((0.0, -1.0, 0.0), (W * 0.5, 0.0, D * 0.5), (0.0, 0.0, 1.0), W, D, (0.75, 0.5, 0.75)),
        ((1.0, 0.0, 0.0), (0.0, H * 0.5, D * 0.5), (0.0, 0.0, 1.0), H, D, (0.75, 0.75, 0.5)),
        ((-1.0, 0.0, 0.0), (W, H * 0.5, D * 0.5), (0.0, 0.0, -1.0), H, D, (0.75, 0.75, 0.5)),
    ]
    for normal, center, up, width, height, color in walls:
        for tri in BoundedPlane.with_material(
            normal, center, up, width, height, 0.001 * D,
            Material.new(color, 0.0, 0.0, TransmissionProperties.none()),
        ).to_basic_geometries():
            scene.add_triangle(tri)

    lights = [
        ((W / 2.0, H / 1.8, 0.016 * D), (0.825, 0.675, 0.5), 0.15),
        ((W / 3.5, H / 3.75, 0.025 * D), (0.825, 0.675, 0.45), 0.485),
        ((W / 1.22, H / 2.9, 0.38 * D), (0.78, 0.67, 0.45), 0.6),
        # NB: the reference subtracts 80 *scene units* here (a window/scene
        # unit mixup quirk) placing this light far off to the left
        ((W - 80.0, H / 2.0, 0.125 * D), (1.0, 1.0, 1.0), 0.1),
        ((W / 2.5, H / 5.0, 0.175 * D), (0.75, 0.56, 0.65), 0.2),
        ((W / 4.0, H / 6.0, 0.01 * D), (0.01, 0.5, 0.4), 0.175),
    ]
    for pos, color, intensity in lights:
        scene.add_light(PointLight.new(pos, color, intensity))

    return scene
