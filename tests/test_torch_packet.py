"""PyTorch port: packet mode (cfg.packet_mode, the reference's SIMD build)
against the JAX package.

Eight consecutive lanes form a packet that shares its spawn decisions, its
depth budgets and the adaptive refraction step (JAX ops/trace.py:107-208).
The cases of tests/test_packet_mode.py, carried into the port through
`device_scene_from_arrays`: heterogeneous packets that straddle two glass
spheres of different opacities (the packet-max opacity couples their
budgets) through `trace_rays` on the stack and the pool path, against the
JAX `trace_rays` (XLA path); homogeneous packets, which must give the bits
of per-ray mode; the pool against the stack; and a `RaytracerRenderer`
frame against the JAX renderer's.

Bar (tests/test_pallas_kernels.py:83-84): `valid` identical; colour within
rtol 2e-5, atol 2e-6; `dropped` equal. Knife edges are set apart as in
tests/test_torch_renderer.py: a lane off the bar must lie in a packet with
a lane whose primary hit (object or point) differs between the packages --
jitted XLA contracts into fused multiply-adds, the port does not, so a hit
point may move by one ulp, and a packet's shared decisions then carry the
difference to all eight lanes. Such lanes stay under 0.5% of the lanes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import Material, PointLight, Scene, SphereData
from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import TransmissionProperties
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import trace as jax_trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import (
    RaytracerRenderer as JaxRenderer,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from scenes import mixed_scene
from test_torch_renderer import moved_hits, one_torch_thread  # noqa: F401 (autouse)
from test_torch_trace import carry

BASE = dict(width=64, height=48, reflections=True, refractions=True, max_nodes=96,
            weight_cutoff=0.0)
# the stack path, and the pool path (R = 384 >= 64 * 2: W = 192, 24 packets)
PATHS = {"stack": dict(compaction_ratio=1),
         "pool": dict(compaction_ratio=2, kernel_ray_tile=64, loop_chunk=16)}


def glass_pair_scene(cfg):
    """tests/test_packet_mode.py's scene: two glass spheres side by side,
    opacity 0.2 (per-ray divisor 3) and 0.6 (divisor 1), a bright diffuse
    sphere behind them, one light."""
    cam = cfg.camera
    w, h, dd = cam.scene_width, cam.scene_height, cam.scene_depth
    s = Scene()
    for x, op in ((0.30, 0.2), (0.62, 0.6)):
        s.add_sphere(SphereData.with_material(
            (x * w, 0.5 * h, 0.4 * dd), 0.22 * dd,
            Material.new((1.0, 1.0, 1.0), 0.0, 0.0, TransmissionProperties.new(op, 1.5))))
    s.add_sphere(SphereData.with_material(
        (0.5 * w, 0.5 * h, 1.05 * dd), 0.4 * dd,
        Material.new((0.9, 0.8, 0.2), 0.0, 0.5, TransmissionProperties.none())))
    s.add_light(PointLight.new((0.5 * w, 0.15 * h, 0.2 * dd), (1, 1, 1), 0.9))
    return s


def straddling_rays(cfg, n_pk=48):
    """Packets of 4 lanes on each sphere (tests/test_packet_mode.py)."""
    cam = cfg.camera
    w, h = cam.scene_width, cam.scene_height
    rng = np.random.default_rng(3)
    py = rng.uniform(0.35, 0.65, n_pk) * h
    ax = rng.uniform(0.22, 0.38, (n_pk, 4)) * w
    bx = rng.uniform(0.54, 0.70, (n_pk, 4)) * w
    px = np.concatenate([ax, bx], axis=1).reshape(-1)
    o = np.stack([px, np.repeat(py, 8), np.zeros(n_pk * 8)], axis=-1).astype(np.float32)
    return o, (o - np.asarray(cam.render_ray_focus, np.float32)).astype(np.float32)


def repeated_rays(cfg, n_pix=32):
    """Homogeneous packets: each pixel's ray eight times."""
    cam = cfg.camera
    rng = np.random.default_rng(7)
    px = rng.uniform(0.1, 0.9, n_pix) * cam.scene_width
    py = rng.uniform(0.1, 0.9, n_pix) * cam.scene_height
    o = np.repeat(np.stack([px, py, np.zeros(n_pix)], axis=-1).astype(np.float32), 8, axis=0)
    return o, (o - np.asarray(cam.render_ray_focus, np.float32)).astype(np.float32)


def port_trace(tds, cfg, o, d):
    c, v, st = trace.trace_rays(tds, cfg, torch.from_numpy(o), torch.from_numpy(d),
                                with_stats=True)
    return c.numpy(), v.numpy(), int(st["dropped"])


def assert_packets_close(jds, tds, o, d, got, ref):
    """The traced-colour bar with the knife-edge rule of the module
    docstring."""
    (c, v, dropped), (c_ref, v_ref, dropped_ref) = got, ref
    np.testing.assert_array_equal(v, v_ref)
    assert dropped == dropped_ref == 0
    off = ~np.isclose(c, c_ref, rtol=2e-5, atol=2e-6).all(-1)
    moved_packet = moved_hits(jds, tds, o, d).reshape(-1, 8).any(1).repeat(8)
    assert not (off & ~moved_packet).any(), np.where(off & ~moved_packet)
    assert off.sum() < 0.005 * off.size, int(off.sum())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_packet_trace_matches_jax(path):
    kw = dict(BASE, **PATHS[path])
    jcfg = JaxConfig(use_pallas=False, packet_mode=True, **kw)
    cfg = RenderConfig(packet_mode=True, **kw)
    jds = jax_build(glass_pair_scene(jcfg), jcfg)
    tds = carry(jds)
    o, d = straddling_rays(cfg)
    c_ref, v_ref, st_ref = jax_trace.trace_rays(jds, jcfg, jnp.asarray(o), jnp.asarray(d),
                                                with_stats=True)
    ref = (np.asarray(c_ref), np.asarray(v_ref), int(st_ref["dropped"]))
    kernels.reset_launch_counts()
    got = port_trace(tds, cfg, o, d)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twins
    assert_packets_close(jds, tds, o, d, got, ref)
    # the packet's shared decisions change the image against per-ray mode
    per_ray = port_trace(tds, dataclasses.replace(cfg, packet_mode=False), o, d)
    np.testing.assert_array_equal(per_ray[1], got[1])
    assert np.abs(per_ray[0] - got[0]).max() > 1e-4


def test_homogeneous_packets_equal_per_ray_mode():
    """Eight identical lanes: every packet reduction gives the lane's own
    value, so packet mode has the bits of per-ray mode (whose resident node
    is the fused node's twin) on the stack and the pool path."""
    jcfg = JaxConfig(use_pallas=False, **BASE)
    tds = carry(jax_build(mixed_scene(jcfg), jcfg))
    for path in PATHS.values():
        cfg = RenderConfig(**dict(BASE, **path))
        o, d = repeated_rays(cfg)
        per_ray = port_trace(tds, cfg, o, d)
        packet = port_trace(tds, dataclasses.replace(cfg, packet_mode=True), o, d)
        assert per_ray[1].any()
        for a, b in zip(packet, per_ray):
            np.testing.assert_array_equal(a, b)


def test_packet_pool_agrees_with_stack():
    """The pool services whole packets (W and every append are multiples of
    8), so in packet mode it agrees with the per-ray stack (JAX
    tests/test_packet_mode.py's bar, rtol 1e-5, atol 1e-6)."""
    jcfg = JaxConfig(use_pallas=False, **BASE)
    tds = carry(jax_build(glass_pair_scene(jcfg), jcfg))
    cfg = RenderConfig(packet_mode=True, **BASE)
    o, d = straddling_rays(cfg)
    stack = port_trace(tds, dataclasses.replace(cfg, **PATHS["stack"]), o, d)
    pool = port_trace(tds, dataclasses.replace(cfg, **PATHS["pool"]), o, d)
    np.testing.assert_array_equal(pool[1], stack[1])
    np.testing.assert_allclose(pool[0], stack[0], rtol=1e-5, atol=1e-6)
    assert pool[2] == stack[2] == 0


def test_packet_checks():
    """Wavefronts of whole packets only, no resort, AA through the renderer
    (JAX ops/trace.py:567-572, renderer.py:177-182)."""
    cfg = RenderConfig(packet_mode=True, **dict(BASE, **PATHS["pool"]))
    jcfg = JaxConfig(use_pallas=False, **BASE)
    tds = carry(jax_build(glass_pair_scene(jcfg), jcfg))
    o, d = straddling_rays(cfg)
    with pytest.raises(ValueError, match="whole 8-lane packets"):
        port_trace(tds, cfg, o[:-4], d[:-4])
    with pytest.raises(ValueError, match="resort_secondary"):
        port_trace(tds, dataclasses.replace(cfg, resort_secondary=True), o, d)
    with pytest.raises(ValueError, match="packet"):
        port_trace(tds, dataclasses.replace(cfg, kernel_ray_tile=60), o, d)
    with pytest.raises(ValueError, match="anti_aliasing"):
        RaytracerRenderer(RenderConfig(packet_mode=True), device="cpu")


def test_packet_frame_matches_jax():
    """A `RaytracerRenderer` frame of the SIMD build (16 lanes a pixel: two
    packets) at 16x12 on the pool path, f32 path, against the JAX
    renderer's."""
    kw = dict(width=16, height=12, reflections=True, refractions=True,
              anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True,
              packet_mode=True, aa_packet_lanes=8, kernel_ray_tile=64, compaction_ratio=4,
              loop_chunk=8, max_nodes=24)
    jcfg = JaxConfig(use_pallas=False, **kw)
    cfg = RenderConfig(**kw)
    jds = jax_build(mixed_scene(jcfg), jcfg)
    tds = carry(jds)
    ref = JaxRenderer(jcfg).render_device(jds)
    r = RaytracerRenderer(cfg, device="cpu")
    got = r.render_device(tds)
    assert r.last_dropped == 0
    np.testing.assert_array_equal(got.valid, ref.valid)
    assert ref.valid.mean() > 0.5
    off = ~np.isclose(got.color, ref.color, rtol=2e-5, atol=2e-6).all(-1)
    assert off.mean() < 0.005, int(off.sum())
    # the u32 path: the same frame within one u8 step
    u32 = RaytracerRenderer(dataclasses.replace(cfg, device_encode=True), device="cpu")
    du8 = np.abs(u32.render_device(tds).as_u8().astype(np.int16) - got.as_u8().astype(np.int16))
    assert du8.max() <= 1
