"""PyTorch port: `cast_rays` on a streamed scene (CPU, through the plain twin
of the `cast_triangles_stream` kernel) against the JAX `cast_rays` through
`pallas_cast_triangles_stream` in interpret mode.

The scene is built once by the JAX package, forced to `streaming=True` with
`dataclasses.replace` (as tests/test_streaming.py:33-63 does) and carried
across as numpy, so both packages see the same arrays. Bar: identical
`valid` and object index; `t` within rtol 2e-6 plus atol 1e-6, the port's
cast bar (tests/test_torch_cast.py: jitted XLA contracts a*b+c into fused
multiply-adds, the port never does).
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
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    cast_rays as jax_cast_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.pallas_kernels import (
    pallas_cast_triangles_stream,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from test_streaming import _clustered_mixed_blocks_scene
from test_torch_cast import T_ATOL, T_RTOL, carry

W, H = 16, 8  # 128 camera rays + 128 random rays: two 128-ray tiles


def _scene(name):
    # semesterbild at triangle_block=32: spheres, big primitives and several
    # Morton blocks to stream; "clustered": the two-cluster scene of
    # tests/test_streaming.py (glass and matte Morton blocks, nothing else)
    cfg = JaxConfig(width=W, height=H, triangle_block=32)
    if name == "clustered":
        ds = jax_build(_clustered_mixed_blocks_scene(cfg), cfg)
    else:
        ds = jax_build(jax_model("semesterbild", cfg), cfg)
    return dataclasses.replace(ds, streaming=True), cfg


def stream_rays(cfg, n_random, seed):
    """W*H camera rays through the pixel centres (the frame's corner rays
    run along the seams of the walls) and n_random seeded rays from inside
    the scene box, half of them aimed at the two clusters of "clustered"."""
    cam = cfg.camera
    box = np.float32([cam.scene_width, cam.scene_height, cam.scene_depth])
    rng = np.random.default_rng(seed)
    px, py = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))
    coords = np.stack(
        [(px.reshape(-1) + 0.5) * cam.w2s_width, (py.reshape(-1) + 0.5) * cam.w2s_height,
         np.zeros(px.size)], axis=-1,
    ).astype(np.float32)
    o_rand = (rng.uniform(0.0, 1.0, (n_random, 3)) * box).astype(np.float32)
    d_rand = rng.normal(size=(n_random, 3)).astype(np.float32)
    k = n_random // 2
    centre = np.where(rng.random((k, 1)) < 0.5, 0.18, 0.80)
    target = (centre + rng.uniform(-0.05, 0.05, (k, 3))) * box
    d_rand[:k] = target - o_rand[:k]
    o = np.concatenate([coords, o_rand])
    d = np.concatenate([coords - np.asarray(cam.render_ray_focus, np.float32), d_rand])
    d = (d / np.sqrt((d * d).sum(axis=1, keepdims=True))).astype(np.float32)
    return o, d


@pytest.fixture(scope="module", params=["clustered", "semesterbild"])
def setup(request):
    ds, cfg = _scene(request.param)
    o, d = stream_rays(cfg, 128, seed=11)
    tds = carry(ds)
    assert tds.streaming and tds.triangle_blocks >= 3
    return request.param, ds, tds, o, d


@pytest.mark.parametrize("backface", [False, True])
def test_streamed_cast_matches_jax(setup, backface):
    name, jds, tds, o, d = setup
    ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), backface,
                        use_pallas=True, interpret=True, ray_tile=128)
    kernels.reset_launch_counts()
    got = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d), backface)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twins
    m = np.asarray(ref.valid)
    idx = np.asarray(ref.obj_idx)
    np.testing.assert_array_equal(got.valid.numpy(), m)
    np.testing.assert_array_equal(got.obj_idx.numpy()[m], idx[m])
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(got.color.numpy()[m], np.asarray(ref.color)[m])
    # hits of every kind the scene has: spheres, big primitives, Morton slots
    S, P = tds.sphere_slots, tds.n_bigtris
    assert (m & (idx >= S + P)).sum() >= 8
    if name == "semesterbild":
        assert (m & (idx < S)).any() and (m & (idx >= S) & (idx < S + P)).any()


def test_streamed_cast_equals_resident_cast(setup):
    """The port's streamed and resident casts give the same hits bit for bit
    (same per-triangle arithmetic, same strict-min order)."""
    _, _, tds, o, d = setup
    a = cast_rays(dataclasses.replace(tds, streaming=False),
                  torch.from_numpy(o), torch.from_numpy(d), True)
    b = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d), True)
    assert torch.equal(a.valid, b.valid) and torch.equal(a.t, b.t)
    assert torch.equal(a.obj_idx[a.valid], b.obj_idx[b.valid])


def test_stream_twin_index_space_matches_pallas(setup):
    """The twin returns the Pallas kernel's local slot b*B + c and its miss
    values (+inf, 2^31-1)."""
    _, jds, tds, o, d = setup
    ref_t, ref_i = pallas_cast_triangles_stream(
        jds.tri_woop, jds.tri_nsq, jds.tri_valid_f, jds.tri_httr_f, jds.tri_normal3,
        jds.tri_aabb, jnp.asarray(o), jnp.asarray(d), ray_tile=128, interpret=True,
    )
    t, i = kernels.cast_triangles_stream(
        tds.tri_cast_pack, tds.tri_aabb, tds.tri_saabb, torch.from_numpy(o),
        torch.from_numpy(d), sb_sizes=tds.sb_sizes,
    )
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    ref_t, ref_i = np.asarray(ref_t), np.asarray(ref_i)
    fin = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(t.numpy()), fin)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_allclose(t.numpy()[fin], ref_t[fin], rtol=T_RTOL, atol=T_ATOL)
    assert fin.any() and (~fin).any()


def test_stream_wrapper_checks_inputs(setup):
    _, _, tds, o, d = setup
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    pack, box, sbox, sizes = tds.tri_cast_pack, tds.tri_aabb, tds.tri_saabb, tds.sb_sizes
    nb = tds.triangle_blocks
    assert sum(sizes) == nb and sbox.shape == (len(sizes), 8)
    with pytest.raises(TypeError):
        kernels.cast_triangles_stream(pack, box, sbox, o.double(), d, sb_sizes=sizes)
    with pytest.raises(ValueError):
        kernels.cast_triangles_stream(pack, box, sbox, o[:, :2], d, sb_sizes=sizes)
    with pytest.raises(ValueError):
        kernels.cast_triangles_stream(pack, box[:-1], sbox, o, d, sb_sizes=sizes)
    with pytest.raises(ValueError):
        kernels.cast_triangles_stream(pack, box, sbox, o.t().contiguous().t(), d, sb_sizes=sizes)
    # the superboxes: one row per entry of sb_sizes, which must cover the blocks
    with pytest.raises(ValueError):
        kernels.cast_triangles_stream(pack, box, sbox[:, :6], o, d, sb_sizes=sizes)
    with pytest.raises(TypeError):
        kernels.cast_triangles_stream(pack, box, sbox, o, d)  # the partition is required
    with pytest.raises(ValueError, match="do not cover"):
        kernels.cast_triangles_stream(pack, box, sbox, o, d,
                                      sb_sizes=sizes[:-1] + (sizes[-1] + 1,))
    with pytest.raises(ValueError, match="do not cover"):
        kernels.cast_triangles_stream(pack, box, box[:2], o, d, sb_sizes=(nb + 1, -1))
    # the CPU route takes any block size (these scenes have blocks of 32
    # rows and narrower ones below)
    t, i = kernels.cast_triangles_stream(pack[:, :24].contiguous(), box, sbox, o, d,
                                         sb_sizes=sizes)
    assert t.shape == (o.shape[0],) and int(i[torch.isfinite(t)].max()) < nb * 24
    assert sum(kernels.LAUNCHES.values()) == 0
