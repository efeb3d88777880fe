"""PyTorch port: the renderer's f32 frame path, the progressive path, the
host-built u32 path and `get_pixel_color`, against the JAX package and
against each other.

Frames against JAX: the same `tests/scenes.py` scene, carried into the port
through `device_scene_from_arrays`, rendered by both renderers on the CPU
(JAX with use_pallas=False; both f32 paths with `render_timing_debug`), the
frame's samples kept as each renderer's `trace_rays_tiled` returned them. Bar
(tests/test_pallas_kernels.py:83-84): `valid` identical; colour within rtol
2e-5, atol 2e-6; `dropped` equal. Knife edges are set apart: a sample off
the bar must be one whose primary hit (object or point) differs between the
packages -- jitted XLA contracts into fused multiply-adds, the port does
not, so a hit point may move by one ulp, and a ray grazing an edge further
down its tree then takes another path. Such samples must be under 0.5% of
the frame's samples (the image bar of tests/test_parity_wavefront.py), and
their pixels are left out of the frame's colour bar.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    cast_rays as jax_cast_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.vecmath import normalized
from hslu_i.ba_raytracing.f2501_raytracer_tpu import renderer as jax_renderer
from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import (
    RaytracerRenderer as JaxRenderer,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import renderer
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import (
    build_frame_rays,
    plan_frame,
)
from scenes import mixed_scene
from test_torch_trace import POOL_CFG, carry

AA = dict(anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while this module's tests run: the
    renders here are many small ops, and in a run of several test workers on
    one CPU each op of an 8-thread pool waits for threads that other workers
    hold (a stack-path frame took 617 s there against 8 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# tests/test_renderer_layout.py:20-31: the stack path (per-ray DFS order)
STACK_CFG = dict(width=33, height=17, reflections=True, refractions=True,
                 weight_cutoff=0.0, compaction_ratio=1)
FRAMES = {
    "aa_realistic_stack": dict(STACK_CFG, **AA),
    "aa_realistic_pool": dict(POOL_CFG, **AA),
    "soft_realistic_pool": dict(POOL_CFG, soft_shadows=True),
    # bench.py:49-57's flags (depths 21/21, ~17 rays per pixel, 28 lights per
    # light) at 12x8 on the pool path; the tree is cut by max_nodes
    "extreme_flags": dict(
        width=12, height=8, reflections=True, light_reflections=True, refractions=True,
        extreme_quality=True, high_quality_model=True, kernel_ray_tile=32,
        compaction_ratio=4, loop_chunk=8, max_nodes=16, weight_cutoff=1e-3, **AA),
}


def moved_hits(jds, tds, o, d):
    """(N,) bool: the primary hit object or point differs between the
    packages."""
    d0 = np.array(normalized(jnp.asarray(d)))
    ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d0))
    hit = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d0))
    moved = np.asarray(ref.obj_idx) != hit.obj_idx.numpy()
    both = hit.valid.numpy() & ~moved
    moved[both] = (np.asarray(ref.point)[both] != hit.point.numpy()[both]).any(-1)
    return moved


def spy(monkeypatch, module, name):
    """Keep the outputs of every call of module.<name> (the renderers'
    per-tile traces) in the returned list."""
    calls, real = [], getattr(module, name)

    def call(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(module, name, call)
    return calls


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_f32_frame_matches_jax(case, monkeypatch):
    kw = dict(FRAMES[case], render_timing_debug=True)
    jcfg = JaxConfig(use_pallas=False, **kw)
    cfg = RenderConfig(**kw)
    assert not cfg.device_encode
    jds = jax_build(mixed_scene(jcfg), jcfg)
    tds = carry(jds)
    # the frame's samples as each renderer traced them (one group of tiles)
    ref_samples = spy(monkeypatch, jax_renderer, "trace_rays_tiled")
    port_samples = spy(monkeypatch, renderer, "trace_rays_tiled")
    ref = JaxRenderer(jcfg).render_device(jds)
    kernels.reset_launch_counts()
    r = RaytracerRenderer(cfg, device="cpu")
    got = r.render_device(tds)
    assert sum(kernels.LAUNCHES.values()) == 0

    plan = plan_frame(cfg)
    n, U = cfg.width * cfg.height, plan.aa
    (c_ref, v_ref, st_ref), = ref_samples
    (c, v, st), = port_samples
    assert r.last_dropped == int(st["dropped"]) == int(st_ref["dropped"])
    c, c_ref = c.numpy().reshape(-1, 3)[: n * U], np.asarray(c_ref).reshape(-1, 3)[: n * U]
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    off = ~np.isclose(c, c_ref, rtol=2e-5, atol=2e-6).all(-1)
    o_all, d_all = (a.reshape(-1, 3)[: n * U] for a in build_frame_rays(cfg, plan))
    moved = moved_hits(jds, tds, o_all, d_all)
    assert not (off & ~moved).any(), np.where(off & ~moved)
    assert off.sum() < 0.005 * off.size, int(off.sum())

    np.testing.assert_array_equal(got.valid, ref.valid)
    assert ref.valid.mean() > 0.5
    edge_px = np.zeros(n, bool)
    edge_px[plan.order] = off.reshape(n, U).any(1)
    keep = ~edge_px.reshape(cfg.height, cfg.width)
    np.testing.assert_allclose(got.color[keep], ref.color[keep], rtol=2e-5, atol=2e-6)


def _frame(**kw):
    """The AA+realistic pool-path frame of mixed_scene, carried into the
    port."""
    cfg = RenderConfig(**dict(POOL_CFG, **AA, **kw))
    jcfg = JaxConfig(use_pallas=False, **dict(POOL_CFG, **AA))
    return cfg, jcfg, carry(jax_build(mixed_scene(jcfg), jcfg))


def test_f32_and_u32_frames_agree():
    """The device-side encode equals the f32 host path in u8 space within
    one step, at under 1% of pixels (tests/test_renderer_layout.py)."""
    cfg, _, ds = _frame()
    a = RaytracerRenderer(cfg, device="cpu").render_device(ds)
    b = RaytracerRenderer(dataclasses.replace(cfg, device_encode=True),
                          device="cpu").render_device(ds)
    np.testing.assert_array_equal(a.valid, b.valid)
    da, db = a.as_u8().astype(np.int16), b.as_u8().astype(np.int16)
    assert np.abs(da - db).max() <= 1
    assert (np.abs(da - db) > 0).mean() < 0.01


def test_progressive_render_equals_fused_frame():
    """One tile at a time, committed through the tile-major permutation:
    the fused f32 frame bit for bit, the last fraction 1.0."""
    cfg, _, ds = _frame(tile_rays=1024)  # 3 tiles of 113 pixels
    assert plan_frame(cfg).n_tiles > 1
    fused = RaytracerRenderer(cfg, device="cpu").render_device(ds)
    seen = []
    prog = RaytracerRenderer(cfg, device="cpu").render_device(
        ds, progress=lambda buf, frac: seen.append(frac))
    assert len(seen) == plan_frame(cfg).n_tiles and seen[-1] == 1.0
    assert seen == sorted(seen)
    np.testing.assert_array_equal(fused.valid, prog.valid)
    np.testing.assert_array_equal(fused.color, prog.color)
    assert len(prog.tile_stats.times) == len(seen)


def test_tile_groups_change_nothing():
    """`tiles_per_program` only groups the tiles traced before a fetch."""
    cfg, _, ds = _frame(tile_rays=1024)
    whole = RaytracerRenderer(cfg, device="cpu").render_device(ds)
    grouped = RaytracerRenderer(dataclasses.replace(cfg, tiles_per_program=2),
                                device="cpu").render_device(ds)
    np.testing.assert_array_equal(whole.valid, grouped.valid)
    np.testing.assert_array_equal(whole.color, grouped.color)
    assert len(grouped.tile_stats.times) == (plan_frame(cfg).n_tiles + 1) // 2


def test_host_built_u32_rays_equal_device_built():
    """`device_ray_gen=False` traces the host-built rays through
    `trace_rays_tiled_u32`: the same u32 frame as the device-built rays,
    a ragged last tile included."""
    cfg, _, ds = _frame(tile_rays=1024, device_encode=True)
    gen = RaytracerRenderer(cfg, device="cpu").render_u32(ds)
    host = RaytracerRenderer(dataclasses.replace(cfg, device_ray_gen=False),
                             device="cpu").render_u32(ds)
    np.testing.assert_array_equal(gen, host)


def test_timing_debug_keeps_tile_stats_and_warns_on_drops(capsys):
    """`render_timing_debug` takes the f32 path even with `device_encode`,
    keeps the tile times and prints the drop warning; an undersized pool
    drops rays and reports them (tests/test_drop_audit.py)."""
    from test_pool_saturation import glass_hall_scene

    kw = dict(POOL_CFG, pool_capacity=1, weight_cutoff=0.0, device_encode=True,
              render_timing_debug=True)
    jcfg = JaxConfig(use_pallas=False, **kw)
    ds = carry(jax_build(glass_hall_scene(jcfg), jcfg))
    r = RaytracerRenderer(RenderConfig(**kw), device="cpu")
    buf = r.render_device(ds)
    out = capsys.readouterr().out
    assert r.last_dropped > 0 and f"{r.last_dropped} pending" in out
    assert buf.tile_stats.summary()["count"] == 1 and buf.valid.any()
    r_quiet = RaytracerRenderer(RenderConfig(**dict(kw, render_timing_debug=False)),
                                device="cpu")
    r_quiet.render_device(ds)
    assert r_quiet.last_dropped == r.last_dropped
    assert "WARNING" in capsys.readouterr().out  # the u32 path warns always


def test_get_pixel_color_matches_jax():
    """One pixel's AA samples traced alone: JAX's `get_pixel_color`, and the
    port's own frame there."""
    cfg, jcfg, ds = _frame()
    jds = jax_build(mixed_scene(jcfg), jcfg)
    r = RaytracerRenderer(cfg, device="cpu")
    buf = r.render_device(ds)
    for x, y in ((12, 6), (3, 2), (21, 10)):
        color, valid = r.get_pixel_color(ds, x, y)
        ref_color, ref_valid = JaxRenderer(jcfg).get_pixel_color(jds, x, y)
        assert color.dtype == np.float32 and color.shape == (3,)
        assert valid == ref_valid == bool(buf.valid[y, x])
        np.testing.assert_allclose(color, ref_color, rtol=0, atol=2e-6)
        np.testing.assert_allclose(color, buf.as_linear()[y, x], rtol=0, atol=1e-6)
