"""PyTorch port: the per-ray stack path and the unpacked pool path against
the JAX package.

* The stack path (`_run_stack`: `_push`, `_pop`, `_body_full` and the
  chunked loop) is taken with compaction_ratio 1 and by tiles smaller than
  kernel_ray_tile * compaction_ratio. It is held against the JAX
  `trace_rays` on its plain path (use_pallas=False: the stack loop runs
  many full-width iterations, too slow for interpret mode). The stop
  condition is read once per loop_chunk, so max_nodes=5 with loop_chunk=4
  runs up to 8 iterations in both packages.
* A stack of one slot cannot hold both children of a branching hit: the
  dropped pushes are counted, equal to JAX's (tests/test_drop_audit.py:83).
* `packed_stage=False` takes the pool's push-dict branch (`shade_eval`,
  then `_pack_entry`); it is held against the JAX pool with its Pallas
  kernels in interpret mode.

Bar (tests/test_pallas_kernels.py:83-84): identical `valid`; colour within
rtol 2e-5, atol 2e-6; knife edges (primary hit object differs) set apart,
at most 0.5% (tests/test_torch_trace.py).
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
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized
from scenes import mixed_scene, translucent_scene
from test_pool_saturation import glass_hall_scene
from test_torch_trace import _rays, carry

CHILDREN = dict(width=24, height=12, reflections=True, refractions=True)
SCENES = {"mixed": mixed_scene, "translucent": translucent_scene, "glass_hall": glass_hall_scene}


def _trace_both(scene_name, kw, pallas):
    jcfg = JaxConfig(use_pallas=pallas, interpret=pallas, **kw)
    cfg = RenderConfig(**kw)
    jds = jax_build(SCENES[scene_name](jcfg), jcfg)
    tds = carry(jds)
    o, d = _rays(cfg)
    ref = jax_trace.trace_rays(jds, jcfg, jnp.asarray(o), jnp.asarray(d), with_stats=True)
    got = trace.trace_rays(tds, cfg, torch.from_numpy(o), torch.from_numpy(d), with_stats=True)
    d0 = normalized(torch.from_numpy(d))
    ref_idx = np.asarray(jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d0.numpy())).obj_idx)
    edge = ref_idx != cast_rays(tds, torch.from_numpy(o), d0).obj_idx.numpy()
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    return got, ref, edge


def _assert_match(got, ref, edge):
    (c, v, st), (c_ref, v_ref, st_ref) = got, ref
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert int(st["dropped"]) == int(st_ref["dropped"])
    assert v.numpy().any() and c.numpy().max() > 0
    np.testing.assert_allclose(
        c.numpy()[~edge], np.asarray(c_ref)[~edge], rtol=2e-5, atol=2e-6
    )


@pytest.mark.parametrize("scene_name,kw", [
    ("mixed", dict(compaction_ratio=1, loop_chunk=8, max_nodes=16)),
    ("translucent", dict(compaction_ratio=1, loop_chunk=8, max_nodes=16)),
    # a tile below kernel_ray_tile * compaction_ratio (288 < 512)
    ("mixed", dict(kernel_ray_tile=256, compaction_ratio=2, loop_chunk=8, max_nodes=16)),
    # stop condition once per chunk: up to 8 iterations at max_nodes 5
    ("glass_hall", dict(compaction_ratio=1, loop_chunk=4, max_nodes=5, weight_cutoff=0.0)),
], ids=["mixed", "translucent", "small-tile", "chunked-stop"])
def test_stack_trace_matches_jax(scene_name, kw):
    got, ref, edge = _trace_both(scene_name, dict(CHILDREN, **kw), pallas=False)
    _assert_match(got, ref, edge)
    assert int(got[2]["dropped"]) == 0


def test_stack_drops_match_jax():
    kw = dict(CHILDREN, compaction_ratio=1, stack_size=1, max_nodes=16, loop_chunk=8,
              weight_cutoff=0.0)
    got, ref, edge = _trace_both("glass_hall", kw, pallas=False)
    _assert_match(got, ref, edge)
    assert int(got[2]["dropped"]) > 0


def test_unpacked_pool_trace_matches_jax_pallas():
    kw = dict(CHILDREN, kernel_ray_tile=128, compaction_ratio=2, loop_chunk=8,
              max_nodes=16, packed_stage=False)
    got, ref, edge = _trace_both("mixed", kw, pallas=True)
    _assert_match(got, ref, edge)
    assert int(got[2]["dropped"]) == 0
