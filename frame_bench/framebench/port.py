"""The system under test behind one adapter: the PyTorch and CUDA port
(`hslu_i.ba_raytracing.f2501_raytracer_tpu_torch`), never the JAX package.

It builds the port's scene from the raw records through the port's `Scene`
builder API, its renderer from the configuration's `RenderConfig` fields,
and exposes what the benchmark reads of it: a frame through `render_u32`
with the frame's `last_dropped` and `last_unfinished`, the launch counter
`kernels.LAUNCHES`, the kernel names, and hooks that see each tile and each
call of a kernel wrapper while frames are traced.
"""

from __future__ import annotations

import contextlib

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (
    BoundedPlane,
    Material,
    PointLight,
    RaytracerRenderer,
    RenderConfig,
    Scene,
    SphereData,
    TransmissionProperties,
    TriangleData,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace

# the device kernels of the port's seven hand-written wrappers, by the names
# the profiler gives them (csrc/*.cu); every other kernel is node glue
KERNEL_NAMES = {
    "cast_triangles": ("cast_triangles_kernel",),
    "cast_triangles_stream": ("cast_triangles_stream_kernel",),
    "occlude_triangles_stream": ("occlude_triangles_stream_kernel",),
    "occlude_triangles": ("occlude_triangles_kernel",),
    "shade_eval_rows": ("shade_eval_rows_kernel",),
    "shade_eval": ("live_slots_kernel", "scan_counts_kernel", "shade_eval_warp_kernel",
                   "shade_eval_lane_kernel"),
    "light_shade": ("light_shade_kernel",),
}


def _kernel_name_match(name: str, pattern: str) -> bool:
    """`cast_triangles_kernel` must not match `cast_triangles_stream_kernel`."""
    i = name.find(pattern)
    return i >= 0 and (i == 0 or not (name[i - 1].isalnum() or name[i - 1] == "_"))


def wrapper_of(kernel_name: str):
    """The port wrapper whose kernel this device event is, or None (glue)."""
    for wrapper, names in KERNEL_NAMES.items():
        if any(_kernel_name_match(kernel_name, n) for n in names):
            return wrapper
    return None


def _material(m):
    trans = TransmissionProperties(refraction_index=m["ior"], opacity=m["opacity"],
                                   boost=m["boost"])
    return Material.new(m["color"], m["metallic"], m["shininess"], trans)


def scene(raw: dict) -> Scene:
    """The port's scene of the raw records, in the reference's order: the
    mesh's triangles, the spheres, the bounded planes' triangles, the
    lights."""
    s = Scene()
    for t in raw["triangles"]:
        v = t["vertices"]
        s.add_triangle(TriangleData.with_material(v[0], v[1], v[2], _material(t["material"])))
    for sp in raw["spheres"]:
        s.add_sphere(SphereData.with_material(sp["center"], sp["radius"],
                                              _material(sp["material"])))
    for p in raw["planes"]:
        plane = BoundedPlane.with_material(p["normal"], p["center"], p["up"], p["width"],
                                           p["height"], p["depth"], _material(p["material"]))
        for tri in plane.to_basic_geometries():
            s.add_triangle(tri)
    for light in raw["lights"]:
        s.add_light(PointLight.new(light["position"], light["color"], light["intensity"]))
    return s


class Port:
    """One renderer and its device scene."""

    def __init__(self, render: dict, width: int, height: int, seed: int, raw: dict, device):
        self.cfg = RenderConfig(width=width, height=height, seed=int(seed), **render)
        self.renderer = RaytracerRenderer(self.cfg, device=device)
        self.dscene = self.renderer.device_scene(scene(raw))

    def frame(self):
        """(u32 pixels (H*W,) on the host, dropped, unfinished)."""
        px = self.renderer.render_u32(self.dscene)
        return px, self.renderer.last_dropped, self.renderer.last_unfinished

    @staticmethod
    def counters() -> dict:
        return dict(kernels.LAUNCHES)

    @staticmethod
    @contextlib.contextmanager
    def hooks(on_tile, wrappers, on_call):
        """While inside: `on_tile()` before each tile is traced, and
        `on_call(wrapper, args, kw, out)` after each call of the kernel
        wrappers named in `wrappers`."""
        saved = {"trace_rays": trace.trace_rays}
        saved.update({w: getattr(kernels, w) for w in wrappers})

        def tile(*a, **k):
            on_tile()
            return saved["trace_rays"](*a, **k)

        def wrap(w):
            def call(*a, **k):
                out = saved[w](*a, **k)
                on_call(w, a, k, out)
                return out
            return call

        trace.trace_rays = tile
        for w in wrappers:
            setattr(kernels, w, wrap(w))
        try:
            yield
        finally:
            trace.trace_rays = saved["trace_rays"]
            for w in wrappers:
                setattr(kernels, w, saved[w])

    def close(self):
        del self.dscene, self.renderer
