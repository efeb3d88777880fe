"""PyTorch port: whole frames of the configs without reflections or
refractions (`default`, `anti_aliasing`, `soft_shadows`; bench.py:37-42)
through `RaytracerRenderer(cfg, device="cpu").render`, against the JAX
package's renderer (its plain path on the CPU) on the same semesterbild
scene with the device-side u32 encode.

Bar: the image bar of tests/test_parity_wavefront.py:30-40: fewer than 0.5%
of pixels off by more than 2e-3 in linear colour (a pixel whose u8 value
differs by one step is off), and `valid` differing at fewer than 0.5% of
pixels (knife edges).
"""

from __future__ import annotations

import numpy as np
import pytest

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import (
    RaytracerRenderer as JaxRenderer,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from test_torch_lighting_trace import LIGHTING


@pytest.mark.parametrize("config", sorted(LIGHTING))
def test_lighting_only_frame_matches_jax(config):
    kw = dict(width=40, height=24, scene_backface_culling=True, tile_rays=4096,
              device_encode=True, **LIGHTING[config])
    ref = JaxRenderer(JaxConfig(**kw)).render(jax_model("semesterbild", JaxConfig(**kw)))
    cfg = RenderConfig(**kw)
    kernels.reset_launch_counts()
    renderer = RaytracerRenderer(cfg, device="cpu")
    got = renderer.render(build("semesterbild", cfg))
    assert sum(kernels.LAUNCHES.values()) == 0 and renderer.last_dropped == 0
    n = got.valid.size
    assert ref.valid.mean() > 0.5
    assert (got.valid != ref.valid).sum() < 0.005 * n
    off = np.abs(got.color - ref.color).max(axis=-1) > 2e-3
    assert off.sum() < 0.005 * n, off.sum()
