"""PyTorch + CUDA port of the TPU-native Whitted raytracer.

A second package beside `f2501_raytracer_tpu` (the JAX reference, which it
never imports): plain tensor code is PyTorch, and each Pallas TPU kernel on
the ported path is a hand-written CUDA C++ kernel for Hopper (sm_90a) in
`csrc/`, with a plain PyTorch twin in `ops/kernels.py`.

Module layout mirrors the JAX package so each counterpart is easy to find:
  config.py       frozen RenderConfig (every flag and derived constant)
  scene/          host scene builder, OBJ loader, lights, DeviceScene
  ops/            vecmath, intersect, shading, trace, kernels (CUDA wrappers)
  renderer.py     frame plan, tiles, the u32 and f32 frame paths, the
                  progressive path, get_pixel_color
  tune.py         `autotune`: the fastest triangle_block for a scene
  models/         the scene zoo (semesterbild, test_scene, test_text)
  output/         PNG writer, colour encoders, terminal and HTTP previews
  __main__.py     the CLI (`python -m ...f2501_raytracer_tpu_torch`)
Entry points run on the card unless the caller passes device="cpu" (the
CLI: --device cpu). Every config of the JAX package renders on one device,
packet mode and the pool's knobs included; ROADMAP.md lists what is still
to come (multi-device meshes).
"""

from .config import (
    DEFAULT_REFRACTION_INDEX,
    RESOLUTION_HIGH,
    RESOLUTION_MEDIUM,
    RESOLUTION_SMALL,
    CameraSpec,
    RenderConfig,
)
from .framebuffer import ImageBuffer
from .materials import Material, TransmissionProperties
from .renderer import RaytracerRenderer
from .scene.builder import (
    BoundedPlane,
    GeometryCollection,
    Isometry3,
    Scene,
    Similarity3,
    SphereData,
    TriangleData,
    rotor3_from_euler_angles,
)
from .scene.device import DeviceScene, build_device_scene, device_scene_from_arrays
from .scene.lighting import AmbientLight, PointLight, SceneLightSource
from .tune import TuneResult, autotune

__all__ = [
    "AmbientLight",
    "BoundedPlane",
    "CameraSpec",
    "DEFAULT_REFRACTION_INDEX",
    "DeviceScene",
    "GeometryCollection",
    "ImageBuffer",
    "Isometry3",
    "Material",
    "PointLight",
    "RESOLUTION_HIGH",
    "RESOLUTION_MEDIUM",
    "RESOLUTION_SMALL",
    "RaytracerRenderer",
    "RenderConfig",
    "Scene",
    "SceneLightSource",
    "Similarity3",
    "SphereData",
    "TransmissionProperties",
    "TriangleData",
    "TuneResult",
    "autotune",
    "build_device_scene",
    "device_scene_from_arrays",
    "rotor3_from_euler_angles",
]

__version__ = "0.1.0"
