"""PyTorch port: the packed-row pool trace, the plain node evaluation and the
device-side pixel encode against the JAX package.

`trace_rays` runs the whole slice on the CPU (cast twin, shade twin, LIFO
pool with on-device count, chunked index_add_ commit) at the config of
tests/test_packed_rows.py:45-49, against the JAX `trace_rays` with its
Pallas kernels in interpret mode. Bar (tests/test_pallas_kernels.py:83-84):
identical `valid`; colour within rtol 2e-5, atol 2e-6; no drops. Knife
edges are set apart: translucent_scene's back wall is a square of two
triangles whose diagonal seam one primary ray follows exactly (float64
gives u+v = 1 on both sides, a miss of both under the strict u+v < 1), so
the winner there depends on last-bit rounding -- jitted XLA contracts into
fused multiply-adds, the port does not. Pixels whose primary hit object
differs between the packages are counted (at most 0.5% of the frame, the
image bar of tests/test_parity_wavefront.py) and left out of the colour bar.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import trace as jax_trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    cast_rays as jax_cast_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.vecmath import normalized
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import device_scene_from_arrays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.camera import pixel_scene_coords
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.device import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
)
from scenes import mixed_scene, translucent_scene

# tests/test_packed_rows.py:45-49: 24x12 = 288 rays >= kernel_ray_tile *
# ratio = 128*2, so the pool path (W = 128, 16 iterations in 2 chunks)
POOL_CFG = dict(
    width=24, height=12, reflections=True, refractions=True,
    kernel_ray_tile=128, compaction_ratio=2, loop_chunk=8, max_nodes=16,
)


def carry(ds):
    fields = {f: np.asarray(getattr(ds, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(ds, f) for f in STATIC_FIELDS}
    return device_scene_from_arrays(fields, static, device="cpu")


def _rays(cfg):
    px, py = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))
    coords = pixel_scene_coords(cfg, px.ravel(), py.ravel())
    dirs = coords - np.asarray(cfg.camera.render_ray_focus, np.float32)
    return coords.astype(np.float32), dirs.astype(np.float32)


SCENES = {"mixed": mixed_scene, "translucent": translucent_scene}


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_pool_trace_matches_jax_pallas(scene_name):
    jcfg = JaxConfig(use_pallas=True, interpret=True, **POOL_CFG)
    cfg = RenderConfig(**POOL_CFG)
    jds = jax_build(SCENES[scene_name](jcfg), jcfg)
    o, d = _rays(cfg)
    c_ref, v_ref, st_ref = jax_trace.trace_rays(
        jds, jcfg, jnp.asarray(o), jnp.asarray(d), with_stats=True
    )
    tds = carry(jds)
    c, v, st = trace.trace_rays(
        tds, cfg, torch.from_numpy(o), torch.from_numpy(d), with_stats=True
    )
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert int(st["dropped"]) == int(st_ref["dropped"]) == 0
    assert v.numpy().any() and c.numpy().max() > 0

    d0 = np.array(normalized(jnp.asarray(d)))  # a writable copy
    ref_idx = np.asarray(jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d0)).obj_idx)
    got_idx = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d0)).obj_idx.numpy()
    edge = ref_idx != got_idx
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    np.testing.assert_allclose(
        c.numpy()[~edge], np.asarray(c_ref)[~edge], rtol=2e-5, atol=2e-6
    )


def test_pool_trace_reports_drops_when_undersized():
    """An undersized logical pool truncates pending rays from the LIFO top
    and counts them, exactly as the JAX pool does."""
    from test_pool_saturation import glass_hall_scene

    # capacity 1 clamps to the floor 2W (tests/test_drop_audit.py:57)
    kw = dict(POOL_CFG, pool_capacity=1, weight_cutoff=0.0)
    jcfg = JaxConfig(use_pallas=True, interpret=True, **kw)
    cfg = RenderConfig(**kw)
    jds = jax_build(glass_hall_scene(jcfg), jcfg)
    o, d = _rays(cfg)
    _, _, st_ref = jax_trace.trace_rays(
        jds, jcfg, jnp.asarray(o), jnp.asarray(d), with_stats=True
    )
    _, _, st = trace.trace_rays(
        carry(jds), cfg, torch.from_numpy(o), torch.from_numpy(d), with_stats=True
    )
    assert int(st["dropped"]) == int(st_ref["dropped"]) > 0


def test_eval_node_plain_matches_jax():
    """The plain node evaluation (`_eval_node`, the JAX use_pallas=False
    path) on a primary wavefront: contribution, hit mask and both children."""
    cfg = RenderConfig(**POOL_CFG)
    jcfg = JaxConfig(use_pallas=False, **POOL_CFG)
    jds = jax_build(mixed_scene(jcfg), jcfg)
    o, d = _rays(cfg)
    d = d / np.sqrt((d * d).sum(axis=1, keepdims=True))
    R = o.shape[0]
    eps = float(cfg.camera.epsilon_distance)
    rng = np.random.default_rng(3)
    ior = np.full((R,), trace.AIR, np.float32)
    w = rng.uniform(0.1, 1.0, (R, 3)).astype(np.float32)
    budget = rng.integers(-1, 6, R).astype(np.int32)
    frefl = rng.random(R) < 0.5
    active = rng.random(R) < 0.9
    ref = jax_trace._eval_node(
        jds, jcfg, eps, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ior),
        jnp.asarray(w), jnp.asarray(budget), jnp.asarray(frefl), jnp.asarray(active),
    )
    t = torch.from_numpy
    got = trace._eval_node(
        carry(jds), cfg, eps, t(o), t(d), t(ior), t(w), t(budget), t(frefl), t(active)
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=2e-5, atol=2e-6)
    for g, r in zip(got[2:], ref[2:]):
        m = np.asarray(r["mask"])
        np.testing.assert_array_equal(g["mask"].numpy(), m)
        assert m.any()
        for k in ("o", "d", "w", "ior"):
            np.testing.assert_allclose(
                g[k].numpy()[m], np.asarray(r[k])[m], rtol=2e-5, atol=2e-6, err_msg=k
            )
        np.testing.assert_array_equal(g["budget"].numpy()[m], np.asarray(r["budget"])[m])


def test_encode_pixels_u32_bit_exact():
    rng = np.random.default_rng(5)
    U, P = 3, 500
    color = rng.uniform(-0.2, 1.2, (P * U, 3)).astype(np.float32)
    # exact half-way values exercise the round-half-up
    color[:30] = (np.arange(90, dtype=np.float32).reshape(30, 3) + 0.5) / 255.0
    valid = rng.random(P * U) < 0.8
    valid[: 3 * U] = False  # some all-miss pixels encode 0
    weights = rng.dirichlet(np.ones(U)).astype(np.float32)
    ref = np.asarray(jax_trace.encode_pixels_u32(
        jnp.asarray(color), jnp.asarray(valid), jnp.asarray(weights)
    ))
    got = trace.encode_pixels_u32(
        torch.from_numpy(color), torch.from_numpy(valid), torch.from_numpy(weights)
    )
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    assert (ref == 0).any() and (ref != 0).any()


def test_raygen_matches_host_rays(monkeypatch):
    """Device-side ray generation rebuilds the host primary rays bit-exactly
    (the JAX package's gen gate, tests/test_renderer_layout.py)."""
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import (
        frame_order_device,
        plan_frame,
    )

    cfg = RenderConfig(**dict(POOL_CFG, device_encode=True))
    plan = plan_frame(cfg)
    order, offs = frame_order_device(cfg, plan, plan.n_tiles, device="cpu")
    seen = {}

    def fake_trace(scene, c, o, d, with_stats=False):
        seen["o"], seen["d"] = o, d
        R = o.shape[0]
        return torch.zeros((R, 3)), torch.zeros((R,), dtype=torch.bool), {
            "dropped": torch.zeros((), dtype=torch.int64)}

    monkeypatch.setattr(trace, "trace_rays", fake_trace)
    per_tile = trace.make_raygen_per_tile(None, cfg, offs, torch.ones(1), plan.pix_per_tile)
    per_tile(order[: plan.pix_per_tile])
    n = cfg.width * cfg.height
    px, py = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))
    coords = pixel_scene_coords(cfg, px.ravel(), py.ravel())[plan.order]
    dirs = coords - np.asarray(cfg.camera.render_ray_focus, np.float32)
    np.testing.assert_array_equal(seen["o"].numpy()[:n], coords)
    np.testing.assert_array_equal(seen["d"].numpy()[:n], dirs)
