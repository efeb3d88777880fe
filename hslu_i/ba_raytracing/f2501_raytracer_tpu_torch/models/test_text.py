"""The "test_text" example (ref examples/test_text.rs:24-49): the OBJ text
mesh with a small rotation/scale and two point lights, nothing else. Without
`RAYTRACER_REF_DATA` the procedural stand-in of models/semesterbild.py takes
the mesh's place."""

from __future__ import annotations

import os

from ..config import RenderConfig
from ..scene.builder import Scene, Similarity3, rotor3_from_euler_angles
from ..scene.lighting import PointLight
from .semesterbild import REF_DATA_ROOT, _procedural_text_scene


def build_scene(cfg: RenderConfig) -> Scene:
    cam = cfg.camera
    W, H, D = cam.scene_width, cam.scene_height, cam.scene_depth

    transform = Similarity3(
        translation=(0.15, 0.0, 0.5),
        rotation=rotor3_from_euler_angles(0.25, 0.2, 0.0),
        scale=1.05,
    )
    obj_path = os.path.join(REF_DATA_ROOT, "data", "obj", "text", "text.obj")
    if REF_DATA_ROOT and os.path.exists(obj_path):
        scene = Scene.from_obj(obj_path, transform, continue_on_material_failure=True)
    else:
        scene = _procedural_text_scene(transform)

    scene.add_light(
        PointLight.new((W / 2.0, H / 1.9, 0.015 * D), (0.825, 0.675, 0.5), 0.99)
    )
    scene.add_light(
        PointLight.new((W / 2.0, H / 2.1, 0.85 * D), (0.825, 0.275, 0.8), 0.99)
    )
    return scene
