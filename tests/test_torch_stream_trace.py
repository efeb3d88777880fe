"""PyTorch port: streamed scenes end to end, against the JAX package.

A scene past `cfg.stream_triangles` (`scene.streaming`) takes the plain node
in every path of `trace_rays`: the cast through the `cast_triangles_stream`
twin, the lighting through the light loop over `occlude_rays` (the
`occlude_triangles_stream` twin), the children in plain PyTorch; the pool
appends per-field children. Held here against the JAX `trace_rays` on its
plain path (use_pallas=False: it has no scene-size ceiling, and is the
oracle of the JAX package's own streaming check), on semesterbild at
triangle_block=32 (several Morton blocks) with `streaming=True` forced on
the port's scene, and against the port's own resident paths.

Bar (tests/test_pallas_kernels.py:83-84): identical `valid`, equal drops,
colour within rtol 2e-5 / atol 2e-6; knife edges set apart, at most 0.5% of
the rays: primary rays whose hit object differs between the packages and
rays whose lighting float32 cannot resolve (tests/test_torch_trace.py,
tests/test_torch_light_shade.py). Frames: the image bar of
tests/test_streaming.py:89-91 (fewer than 0.5% of pixels off by more than
2e-3).

The slowest cases live in files of their own, so that test workers that
take a file each share them out: the stack path's three traced cases in
tests/test_torch_stream_trace_stack.py (which runs this module's tests on
its own `traced`), the pool frame in tests/test_torch_stream_frame.py.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import trace as jax_trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    cast_rays as jax_cast_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import (
    RaytracerRenderer as JaxRenderer,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (
    RaytracerRenderer,
    RenderConfig,
    build_device_scene,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized
from test_torch_light_shade import ill_conditioned
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_trace import _rays, carry

BASE = dict(width=24, height=12, triangle_block=32)
CHILDREN = dict(reflections=True, refractions=True)
PATHS = {
    # 288 rays >= kernel_ray_tile * ratio = 256: the pool, W = 128
    "pool": dict(CHILDREN, kernel_ray_tile=128, compaction_ratio=2, loop_chunk=8,
                 max_nodes=16),
    "stack": dict(CHILDREN, compaction_ratio=1, loop_chunk=8, max_nodes=16),
    "lighting": dict(),
}


def trace_path(name):
    """The same rays through the JAX plain path, the port's streamed path
    and the port's resident path on path `name` of PATHS."""
    kw = dict(BASE, **PATHS[name])
    jcfg = JaxConfig(use_pallas=False, **kw)
    cfg = RenderConfig(**kw)
    jds = jax_build(jax_model("semesterbild", jcfg), jcfg)
    tds = carry(jds)
    assert not tds.streaming and tds.triangle_blocks >= 3
    o, d = _rays(cfg)
    ref = jax_trace.trace_rays(jds, jcfg, jnp.asarray(o), jnp.asarray(d), with_stats=True)
    t = torch.from_numpy
    kernels.reset_launch_counts()
    streamed = trace.trace_rays(dataclasses.replace(tds, streaming=True), cfg, t(o), t(d),
                                with_stats=True)
    resident = trace.trace_rays(tds, cfg, t(o), t(d), with_stats=True)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twins

    d0 = normalized(t(d))
    hit = cast_rays(tds, t(o), d0, cfg.backface_culling)
    ref_idx = np.asarray(jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d0.numpy())).obj_idx)
    edge = ref_idx != hit.obj_idx.numpy()
    point = torch.where(hit.valid[:, None], hit.point, torch.full_like(hit.point, 1e9))
    edge |= ill_conditioned(tds, point, hit.normal, d0, hit.color, hit.shininess, hit.valid,
                            float(cfg.camera.epsilon_distance), cfg.backface_culling)
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    return name, streamed, resident, ref, edge


@pytest.fixture(scope="module", params=["lighting", "pool"])
def traced(request):
    return trace_path(request.param)


def test_streamed_trace_matches_jax(traced):
    _, (c, v, st), _, (c_ref, v_ref, st_ref), edge = traced
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert int(st["dropped"]) == int(st_ref["dropped"]) == 0
    assert v.numpy().any() and np.asarray(c_ref).max() > 0
    np.testing.assert_allclose(c.numpy()[~edge], np.asarray(c_ref)[~edge],
                               rtol=2e-5, atol=2e-6)


def test_streamed_trace_matches_resident_trace(traced):
    """Same rays, same scene, the port's own two routes: the kernels' twins
    add the shadow sums in another order (`tri_blk_pack` against
    `tri_cast_pack` block order), nothing else differs."""
    _, (c, v, st), (c_res, v_res, st_res), _, _ = traced
    assert torch.equal(v, v_res) and int(st["dropped"]) == int(st_res["dropped"])
    np.testing.assert_allclose(c.numpy(), c_res.numpy(), rtol=2e-5, atol=2e-6)


def test_streamed_paths_take_the_plain_node(monkeypatch, traced):
    """Under `streaming` no path reaches the fused node or light kernels'
    wrappers, and the casts and shadow rays go through the streamed ones."""
    name = traced[0]
    calls = {k: 0 for k in kernels.KERNEL_SOURCES}

    def counted(k, fn):
        def wrapper(*a, **kw):
            calls[k] += 1
            return fn(*a, **kw)
        return wrapper

    for k in calls:
        monkeypatch.setattr(kernels, k, counted(k, getattr(kernels, k)))
    kw = dict(BASE, **PATHS[name])
    cfg = RenderConfig(**kw)
    ds = build_device_scene(build("semesterbild", cfg), dataclasses.replace(cfg, stream_triangles=1),
                            device="cpu")
    assert ds.streaming
    o, d = _rays(cfg)
    trace.trace_rays(ds, cfg, torch.from_numpy(o), torch.from_numpy(d))
    used = {k for k, n in calls.items() if n}
    assert used == {"cast_triangles_stream", "occlude_triangles_stream"}, calls
    # one occlusion call per light chunk and node: all lights fit one chunk here
    assert calls["occlude_triangles_stream"] == calls["cast_triangles_stream"]
    if name != "lighting":
        assert calls["cast_triangles_stream"] > 1


def test_build_flips_streaming_at_the_threshold():
    cfg = RenderConfig(**BASE)
    scene = build("semesterbild", cfg)
    ds = build_device_scene(scene, cfg, device="cpu")
    assert not ds.streaming and ds.n_triangles < cfg.stream_triangles
    at = dataclasses.replace(cfg, stream_triangles=ds.n_triangles)
    below = dataclasses.replace(cfg, stream_triangles=ds.n_triangles - 1)
    assert not build_device_scene(scene, at, device="cpu").streaming
    assert build_device_scene(scene, below, device="cpu").streaming


def check_streamed_frame(path):
    """`RaytracerRenderer.render` with the threshold lowered to 1 on `path`
    ("pool" or "lighting"): the frame against the JAX renderer (plain path)
    and against the port's resident frame."""
    feats = dict(CHILDREN, kernel_ray_tile=128, compaction_ratio=2, loop_chunk=8,
                 max_nodes=16) if path == "pool" else {}
    kw = dict(width=32, height=20, scene_backface_culling=True, tile_rays=4096,
              device_encode=True, triangle_block=32, **feats)
    jcfg = JaxConfig(use_pallas=False, **kw)
    ref = JaxRenderer(jcfg).render(jax_model("semesterbild", jcfg))
    frames = {}
    for label, extra in (("streamed", dict(stream_triangles=1)), ("resident", {})):
        cfg = RenderConfig(**kw, **extra)
        renderer = RaytracerRenderer(cfg, device="cpu")
        ds = renderer.device_scene(build("semesterbild", cfg))
        assert ds.streaming == (label == "streamed")
        frames[label] = renderer.render_device(ds)
        assert renderer.last_dropped == 0
    # the entry point a user calls: the scene in, the streamed frame out
    cfg = RenderConfig(**kw, stream_triangles=1)
    via_render = RaytracerRenderer(cfg, device="cpu").render(build("semesterbild", cfg))
    np.testing.assert_array_equal(via_render.color, frames["streamed"].color)
    got, res = frames["streamed"], frames["resident"]
    n = got.valid.size
    assert ref.valid.mean() > 0.5
    np.testing.assert_array_equal(got.valid, res.valid)
    assert (got.valid != ref.valid).sum() < 0.005 * n
    for other in (ref, res):
        off = np.abs(got.color - other.color).max(axis=-1) > 2e-3
        assert off.sum() < 0.005 * n, off.sum()


@pytest.mark.parametrize("path", ["lighting"])
def test_streamed_frame_matches_jax_and_resident(path):
    check_streamed_frame(path)
