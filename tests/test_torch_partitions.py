"""PyTorch port: block partitions that the JAX package takes
(ops/pallas_kernels.py:149-160), through the port's CPU route against the
JAX package on its plain path (use_pallas=False).

The scene is semesterbild plus a seeded cloud of small triangles, a quarter
of them glass (the port's models/triangle_cloud.py; the same triangles go
into the JAX package's scene here), resident, at two partitions:

* `superblock64`: RenderConfig(triangle_block=32, superblock=64), more than
  32 Morton blocks in one superblock;
* `block48`: triangle_block=48, blocks whose row count is no multiple of 32.

On the card the kernels with a warp per ray take both (superblocks of more
than 32 blocks in rounds of 32 lanes, a ragged last round of rows); the
`gpu` tests of tests/test_torch_kernels_gpu.py hold them there against
these twins. Bars (ROADMAP.md): the scene tables the same; the cast with
identical `valid` and object index, t within rtol 2e-6 + atol 1e-6 (jitted
XLA contracts into fused multiply-adds, the port does not); the occlusion
with identical `opq`, the sums within 1e-5 where it is false; the traced
colour of the pool and the stack path with identical `valid`, within rtol
2e-5 / atol 2e-6, knife edges (primary hit object differs) at most 0.5% and
set apart. The trace of block48 on the stack path, the slowest case, lives in
tests/test_torch_partition_trace_block48.py, so that test workers that take
a file each share them out.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.materials import Material as JaxMaterial
from hslu_i.ba_raytracing.f2501_raytracer_tpu.materials import (
    TransmissionProperties as JaxTransmission,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import trace as jax_trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    cast_rays as jax_cast_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    occlude_rays as jax_occlude_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.scene.builder import TriangleData as JaxTriangle
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig, build_device_scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import triangle_cloud
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays, occlude_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness import PARTITIONS
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_trace import _rays, carry

CLOUD = dict(n=1100, edge_sigma=0.05, glass_share=0.25, seed=7)
PATHS = {
    # 288 rays >= kernel_ray_tile * ratio = 256: the pool, W = 128
    "pool": dict(kernel_ray_tile=128, compaction_ratio=2, loop_chunk=8, max_nodes=16),
    "stack": dict(compaction_ratio=1, loop_chunk=4, max_nodes=8),
}
BASE = dict(width=24, height=12, reflections=True, refractions=True)


def _jax_cloud_scene(jcfg):
    """The JAX package's semesterbild plus the cloud of
    triangle_cloud.build_scene, drawn the same way from the same seed."""
    scene = jax_model("semesterbild", jcfg)
    cam = jcfg.camera
    W, H, D = cam.scene_width, cam.scene_height, cam.scene_depth
    lo = np.array([0.02 * W, 0.02 * H, 0.05 * D], np.float64)
    hi = np.array([0.98 * W, 0.9 * H, 0.8 * D], np.float64)
    n, sigma = CLOUD["n"], CLOUD["edge_sigma"]
    rng = np.random.default_rng(CLOUD["seed"])
    c = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, sigma, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, sigma, (n, 3)).astype(np.float32)
    glass = c[:, 0] < lo[0] + CLOUD["glass_share"] * (hi[0] - lo[0])
    v2, v3 = c + e1, c + e2
    normal = np.cross(v2 - c, v3 - c)
    norm = np.linalg.norm(normal, axis=1, keepdims=True)
    normal = np.where(norm > 0, normal / np.where(norm > 0, norm, 1), normal).astype(np.float32)
    matte = JaxMaterial((0.5, 0.5, 0.5), 0.0, 0.2)
    glass_m = JaxMaterial.new((0.9, 0.95, 1.0), 0.0, 0.2, JaxTransmission.new(0.35, 1.5))
    for i in range(n):
        scene.add_triangle(JaxTriangle(c[i], v2[i], v3[i], normal[i],
                                       glass_m if glass[i] else matte))
    return scene


def _scenes(partition, **kw):
    """(port config, JAX config, JAX device scene, the port's own build, the
    JAX scene carried into the port)."""
    kw = dict(BASE, **PARTITIONS[partition], **kw)
    jcfg = JaxConfig(use_pallas=False, **kw)
    cfg = RenderConfig(**kw)
    jds = jax_build(_jax_cloud_scene(jcfg), jcfg)
    own = build_device_scene(triangle_cloud.build_scene(cfg, **CLOUD), cfg, device="cpu")
    return cfg, jcfg, jds, own, carry(jds)


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
def test_partition_scene_matches_jax(partition):
    """The port's scene build gives the JAX package's partition and tables."""
    _, _, jds, own, _ = _scenes(partition)
    B = PARTITIONS[partition]["triangle_block"]
    assert own.tri_block == jds.tri_block == B
    assert tuple(own.sb_sizes) == tuple(jds.sb_sizes)
    assert (max(own.sb_sizes) > 32) == (partition == "superblock64"), own.sb_sizes
    assert not own.streaming and own.triangle_blocks >= 20
    for name in ("tri_cast_pack", "tri_aabb", "tri_saabb", "tri_blk_pack", "tri_blk_aabb"):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      np.asarray(getattr(jds, name)), err_msg=name)


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
def test_partition_cast_and_occlusion_match_jax(partition):
    """The scene-level cast and occlusion over every block of the
    partition, on primary rays and on shadow rays towards the first light."""
    cfg, _, jds, _, tds = _scenes(partition)
    o, d = _rays(cfg)
    d = d / np.sqrt((d * d).sum(axis=1, keepdims=True))
    ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d))
    got = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.obj_idx.numpy()[valid], np.asarray(ref.obj_idx)[valid])
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid], rtol=2e-6,
                               atol=1e-6)
    cloud = np.asarray(ref.obj_idx)[valid] >= tds.sphere_slots + tds.n_bigtris
    assert cloud.any() and valid.mean() > 0.5  # rays that hit the cloud's blocks
    # shadow rays from the hits towards the first light
    point = np.asarray(ref.point)[valid]
    light = np.asarray(tds.light_pack[0, 0:3].numpy())
    to_light = light[None, :] - point
    md = np.sqrt((to_light * to_light).sum(axis=1)).astype(np.float32)
    sd = (to_light / md[:, None]).astype(np.float32)
    so = (point + sd * 1e-3).astype(np.float32)
    ref_o = jax_occlude_rays(jds, jnp.asarray(so), jnp.asarray(sd), jnp.asarray(md), False)
    got_o = occlude_rays(tds, torch.from_numpy(so), torch.from_numpy(sd), torch.from_numpy(md),
                         False)
    opq = np.asarray(ref_o[0])
    np.testing.assert_array_equal(got_o[0].numpy(), opq)
    for g, r in zip(got_o[1:], ref_o[1:]):
        np.testing.assert_allclose(g.numpy()[~opq], np.asarray(r)[~opq], atol=1e-5)
    assert opq.any() and not opq.all()


def check_partition_trace(partition, path):
    """The traced colour of path `path` (PATHS) at `partition`."""
    cfg, jcfg, jds, _, tds = _scenes(partition, **PATHS[path])
    o, d = _rays(cfg)
    ref = jax_trace.trace_rays(jds, jcfg, jnp.asarray(o), jnp.asarray(d), with_stats=True)
    got = trace.trace_rays(tds, cfg, torch.from_numpy(o), torch.from_numpy(d), with_stats=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]["dropped"]) == int(ref[2]["dropped"]) == 0
    d0 = normalized(torch.from_numpy(d))
    ref_idx = np.asarray(jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d0.numpy())).obj_idx)
    edge = ref_idx != cast_rays(tds, torch.from_numpy(o), d0).obj_idx.numpy()
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    np.testing.assert_allclose(got[0].numpy()[~edge], np.asarray(ref[0])[~edge], rtol=2e-5,
                               atol=2e-6)
    assert got[0].numpy().max() > 0


@pytest.mark.parametrize("partition, path", [
    (partition, path) for partition in sorted(PARTITIONS) for path in sorted(PATHS)
    if (partition, path) != ("block48", "stack")])
def test_partition_trace_matches_jax(partition, path):
    check_partition_trace(partition, path)
