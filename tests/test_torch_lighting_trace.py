"""PyTorch port: `trace_rays` of the configs without reflections or
refractions (BASELINE.json configs 1-3: `default`, `anti_aliasing`,
`soft_shadows`) against the JAX `trace_rays` with its Pallas kernels in
interpret mode. The port runs the primary node alone: the cast twin, then
`calculate_lighting` through the `light_shade` twin, ambient added outside.

The anti_aliasing wavefront is the frame's: every pixel's deduped AA
samples from `plan_frame` (consecutive per pixel), as the renderer traces
them. Bar (tests/test_pallas_kernels.py:83-84): identical `valid`; colour
within rtol 2e-5, atol 2e-6; no drops. Knife edges are set apart, at most
0.5% of the rays together: primary rays whose hit object differs between
the packages (tests/test_torch_trace.py) and rays whose lighting float32
cannot resolve to the bar (tests/test_torch_light_shade.py).
"""

from __future__ import annotations

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
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import plan_frame
from scenes import mixed_scene
from test_torch_light_shade import ill_conditioned
from test_torch_trace import _rays, carry

# bench.py:37-42 feature sets
LIGHTING = {
    "default": dict(),
    "anti_aliasing": dict(anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True),
    "soft_shadows": dict(soft_shadows=True),
}


def frame_rays(cfg):
    """Every pixel's AA samples, consecutive per pixel (renderer.py)."""
    o, d = _rays(cfg)
    offs = plan_frame(cfg).offsets
    U = offs.shape[0]
    o = (o[:, None, :] + offs[None, :, :]).reshape(-1, 3).astype(np.float32)
    return o, np.repeat(d, U, axis=0), U


def compare_traces(scene_fn, kw, pallas=True):
    """Trace the same rays through both packages; returns (port colour,
    JAX colour, knife-edge mask, rays per pixel). Asserts identical
    `valid` and equal, zero drops."""
    jcfg = JaxConfig(use_pallas=pallas, interpret=pallas, **kw)
    cfg = RenderConfig(**kw)
    jds = jax_build(scene_fn(jcfg), jcfg)
    tds = carry(jds)
    o, d, U = frame_rays(cfg)
    c_ref, v_ref, st_ref = jax_trace.trace_rays(
        jds, jcfg, jnp.asarray(o), jnp.asarray(d), with_stats=True
    )
    kernels.reset_launch_counts()
    c, v, st = trace.trace_rays(
        tds, cfg, torch.from_numpy(o), torch.from_numpy(d), with_stats=True
    )
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twins
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert int(st["dropped"]) == int(st_ref["dropped"]) == 0

    d0 = normalized(torch.from_numpy(d))
    hit = cast_rays(tds, torch.from_numpy(o), d0, cfg.backface_culling)
    ref_idx = np.asarray(jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d0.numpy())).obj_idx)
    edge = ref_idx != hit.obj_idx.numpy()
    point = torch.where(hit.valid[:, None], hit.point, torch.full_like(hit.point, 1e9))
    edge |= ill_conditioned(tds, point, hit.normal, d0, hit.color, hit.shininess, hit.valid,
                            float(cfg.camera.epsilon_distance), cfg.backface_culling)
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    return c.numpy(), np.asarray(c_ref), edge, U


@pytest.mark.parametrize("config", sorted(LIGHTING))
def test_lighting_only_trace_matches_jax(config):
    kw = dict(width=12, height=8, kernel_ray_tile=128, **LIGHTING[config])
    c, c_ref, edge, U = compare_traces(mixed_scene, kw)
    assert (U > 1) == (config == "anti_aliasing")
    assert c_ref.max() > 0
    np.testing.assert_allclose(c[~edge], c_ref[~edge], rtol=2e-5, atol=2e-6)


def test_lighting_only_semesterbild_matches_jax():
    """The benchmark scene, `default` config, on the JAX plain path."""
    def scene_fn(cfg):
        return jax_model("semesterbild", cfg)

    kw = dict(width=24, height=16, triangle_block=64)
    c, c_ref, edge, _ = compare_traces(scene_fn, kw, pallas=False)
    assert c_ref.max() > 0
    np.testing.assert_allclose(c[~edge], c_ref[~edge], rtol=2e-5, atol=2e-6)
