from .builder import (
    BoundedPlane,
    GeometryCollection,
    Isometry3,
    Scene,
    Similarity3,
    SphereData,
    TriangleData,
    rotor3_from_euler_angles,
)
from .device import DeviceScene, build_device_scene, device_scene_from_arrays
from .lighting import AmbientLight, PointLight, SceneLightSource, preprocess_lights
