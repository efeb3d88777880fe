"""PyTorch port: the DeviceScene build equals the JAX package's, field by field.

The port keeps its own copy of the host-side scene pipeline (config,
materials, builder, lights, semesterbild, Morton order, Woop transforms,
packs, AABB and superblock tables). Built from the same configuration, every
array must be bit-identical to the JAX `build_device_scene` and every static
field equal; `device_scene_from_arrays` must carry a JAX scene across
unchanged (the tests of the kernels feed both packages that way).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.scene.builder import Scene as JaxScene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import build_device_scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import device_scene_from_arrays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.device import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
)

# (width, height, scene_backface_culling): two small frames, and the 1080p
# frame of the main path (triangle_block resolves to 64 there)
CASES = [(64, 48, False), (64, 48, True), (1920, 1080, True)]
REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)


def _jax_scene(w, h, cull):
    cfg = JaxConfig(width=w, height=h, scene_backface_culling=cull, **REALISTIC)
    scene = jax_model("semesterbild", cfg)
    if cull:
        scene = JaxScene.backface_culling(scene, np.array([0.0, 0.0, 1.0]))
    return jax_build(scene, cfg)


def _jax_arrays(ds):
    fields = {f: np.asarray(getattr(ds, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(ds, f) for f in STATIC_FIELDS}
    return fields, static


@pytest.mark.parametrize("w,h,cull", CASES)
def test_device_scene_fields_equal_jax(w, h, cull):
    cfg = RenderConfig(width=w, height=h, scene_backface_culling=cull, **REALISTIC)
    scene = build("semesterbild", cfg)
    if cull:
        scene = Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0]))
    ds = build_device_scene(scene, cfg, device="cpu")
    ref_fields, ref_static = _jax_arrays(_jax_scene(w, h, cull))

    jax_names = {f.name for f in dataclasses.fields(_jax_scene(w, h, cull))}
    assert jax_names == set(ARRAY_FIELDS) | set(STATIC_FIELDS)
    for name in ARRAY_FIELDS:
        got = getattr(ds, name).numpy()
        ref = ref_fields[name]
        assert got.dtype == ref.dtype, name
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for name in STATIC_FIELDS:
        assert getattr(ds, name) == ref_static[name], name


def test_main_path_scene_shapes():
    """The 1080p main-path scene: 5 lights, 9 spheres, 48 big triangles,
    128 Morton triangles in 2 blocks of 64."""
    cfg = RenderConfig(width=1920, height=1080, scene_backface_culling=True, **REALISTIC)
    scene = Scene.backface_culling(
        build("semesterbild", cfg), np.array([0.0, 0.0, 1.0])
    )
    ds = build_device_scene(scene, cfg, device="cpu")
    assert ds.n_lights == 5
    assert tuple(ds.light_pack.shape) == (8, 8)
    assert tuple(ds.sph_pack.shape) == (16, 16)
    assert tuple(ds.trb_pack.shape) == (48, 32)
    assert tuple(ds.tri_blk_pack.shape) == (2, 64, 32)
    assert tuple(ds.tri_cast_pack.shape) == (2, 64, 32)
    assert tuple(ds.mat_pack.shape) == (192, 16)


def test_device_scene_from_arrays_round_trips():
    ref = _jax_scene(64, 48, True)
    fields, static = _jax_arrays(ref)
    ds = device_scene_from_arrays(fields, static, device="cpu")
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ds, name).numpy(), fields[name], err_msg=name)
    for name in STATIC_FIELDS:
        assert getattr(ds, name) == getattr(ref, name), name
    with pytest.raises(ValueError):
        device_scene_from_arrays({k: v for k, v in fields.items() if k != "mat_pack"},
                                 static, device="cpu")


def test_streamed_scene_equals_jax_and_crosses_unchanged():
    """`stream_triangles` lowered below the scene's triangle slots: both
    builds set `streaming`, every field stays bit-equal, and the JAX scene
    carried across as numpy keeps `streaming` and `block_has_trans`."""
    kw = dict(width=64, height=48, triangle_block=32, stream_triangles=64, **REALISTIC)
    jcfg = JaxConfig(**kw)
    ref = jax_build(jax_model("semesterbild", jcfg), jcfg)
    cfg = RenderConfig(**kw)
    ds = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    ref_fields, ref_static = _jax_arrays(ref)
    assert ref.streaming and ds.streaming and ds.n_triangles > cfg.stream_triangles
    assert len(ds.block_has_trans) == ds.triangle_blocks >= 3
    carried = device_scene_from_arrays(ref_fields, ref_static, device="cpu")
    for scene in (ds, carried):
        for name in ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(scene, name).numpy(), ref_fields[name],
                                          err_msg=name)
        for name in STATIC_FIELDS:
            assert getattr(scene, name) == ref_static[name], name
    # the streamed kernels read the cast-order pack: the planar arrays' values
    B = ds.tri_block
    np.testing.assert_array_equal(
        ds.tri_cast_pack[:, :, 0:12].numpy(), ds.tri_woop.numpy().transpose(0, 2, 1))
    np.testing.assert_array_equal(ds.tri_cast_pack[:, :, 14].numpy(), ds.tri_httr_f.numpy())
    np.testing.assert_array_equal(
        ds.tri_cast_pack[:, :, 22:25].numpy(), ds.tri_absn.numpy().transpose(0, 2, 1))
    assert ds.tri_cast_pack.shape == (ds.triangle_blocks, B, 32)


def _superblock_scene(name):
    if name == "cloud":
        # the streamed frame's scene at a tenth of its cloud, at the 1080p
        # block size, forced past the threshold
        from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import triangle_cloud

        cfg = RenderConfig(width=1920, height=1080, scene_backface_culling=True,
                           stream_triangles=4096, **REALISTIC)
        scene = Scene.backface_culling(triangle_cloud.build_scene(cfg, n=12_000),
                                       np.array([0.0, 0.0, 1.0]))
        return build_device_scene(scene, cfg, device="cpu")
    if name == "cloud_padded":
        cfg = RenderConfig(width=64, height=48, triangle_block=32, stream_triangles=64,
                           **REALISTIC)
        return build_device_scene(build("semesterbild", cfg), cfg, min_tri_blocks=7,
                                  device="cpu")
    jcfg = JaxConfig(width=64, height=48, triangle_block=32, stream_triangles=64, **REALISTIC)
    fields, static = _jax_arrays(jax_build(jax_model("semesterbild", jcfg), jcfg))
    return device_scene_from_arrays(fields, static, device="cpu")


@pytest.mark.parametrize("name", ["cloud", "cloud_padded", "carried_from_jax"])
def test_streamed_scene_carries_superboxes_over_its_blocks(name):
    """What the streamed kernels' two-level gate reads: `sb_sizes` partitions
    the blocks of `tri_cast_pack` in storage order, `tri_saabb` has one row
    per group, and every superbox contains the boxes of its blocks. An empty
    block has an inverted box, no valid row, and a group of its own."""
    ds = _superblock_scene(name)
    nb = ds.triangle_blocks
    assert ds.streaming and ds.tri_cast_pack.shape[0] == nb == ds.tri_aabb.shape[0]
    assert sum(ds.sb_sizes) == nb and min(ds.sb_sizes) >= 1
    assert tuple(ds.tri_saabb.shape) == (len(ds.sb_sizes), 8)
    assert len(ds.sb_sizes) < nb and max(ds.sb_sizes) <= 32
    box, sbox = ds.tri_aabb.numpy(), ds.tri_saabb.numpy()
    empty = (box[:, 0:3] > box[:, 3:6]).any(axis=1)
    assert not ds.tri_cast_pack.numpy()[empty][..., 13].any()
    assert empty.any() == (name == "cloud_padded")
    start = 0
    for g, n in enumerate(ds.sb_sizes):
        inside = slice(start, start + n)
        if empty[inside].any():
            assert n == 1 and (sbox[g, 0:3] > sbox[g, 3:6]).all()
        else:
            assert (sbox[g, 0:3] <= box[inside, 0:3]).all()
            assert (sbox[g, 3:6] >= box[inside, 3:6]).all()
            # and is no larger than their union
            np.testing.assert_array_equal(sbox[g, 0:3], box[inside, 0:3].min(axis=0))
            np.testing.assert_array_equal(sbox[g, 3:6], box[inside, 3:6].max(axis=0))
        start += n
    # every valid triangle's Woop row lies in a block whose box is not inverted
    valid = ds.tri_cast_pack.numpy()[..., 13] != 0
    assert valid[~empty].any(axis=1).all()


def _resident_scene(name):
    if name == "carried_from_jax":
        fields, static = _jax_arrays(_jax_scene(64, 48, True))
        return device_scene_from_arrays(fields, static, device="cpu")
    w, h, kw = {"1080p": (1920, 1080, {}), "240x135": (240, 135, {}),
                "64x48_block32": (64, 48, dict(triangle_block=32))}[name]
    cfg = RenderConfig(width=w, height=h, scene_backface_culling=True, **kw, **REALISTIC)
    scene = Scene.backface_culling(build("semesterbild", cfg), np.array([0.0, 0.0, 1.0]))
    return build_device_scene(scene, cfg, device="cpu")


@pytest.mark.parametrize("name", ["1080p", "240x135", "64x48_block32", "carried_from_jax"])
def test_resident_scene_meets_the_warp_kernels_needs(name):
    """What the resident kernels with a warp per ray need of the scenes the
    card renders (`kernels._warp_tables`, `_check_big_rows`): blocks of a
    multiple of 32 rows, at most 128 big rows, `sb_sizes` partitioning the
    cast-order blocks in groups of at most 32, and every superbox containing
    the boxes of its blocks (an empty block's box is inverted and alone)."""
    ds = _resident_scene(name)
    nb, B, _ = ds.tri_cast_pack.shape
    assert not ds.streaming and B % 32 == 0 and tuple(ds.tri_blk_pack.shape) == (nb, B, 32)
    assert sum(ds.sb_sizes) == nb and 1 <= min(ds.sb_sizes) and max(ds.sb_sizes) <= 32
    box, sbox = ds.tri_aabb.numpy(), ds.tri_saabb.numpy()
    empty = (box[:, 0:3] > box[:, 3:6]).any(axis=1)
    starts = np.concatenate([[0], np.cumsum(ds.sb_sizes)])
    for g in range(len(ds.sb_sizes)):
        inside = slice(starts[g], starts[g + 1])
        real = ~empty[inside]
        if not real.any():
            continue
        assert (sbox[g, 0:3] <= box[inside, 0:3][real]).all()
        assert (sbox[g, 3:6] >= box[inside, 3:6][real]).all()
    kernels._check_big_rows(ds.trb_pack)
    sb, nsb, shift = kernels._warp_tables(ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb,
                                          ds.sb_sizes, trb_pack=ds.trb_pack)
    assert sb.tolist() == starts.tolist() and nsb == len(ds.sb_sizes)
    assert 1 << shift >= max(ds.sb_sizes)
    # the node kernel's gate: each tri_blk_pack block a superblock of its own
    _, nsb, shift = kernels._warp_tables(ds.tri_blk_pack, ds.tri_blk_aabb, ds.tri_blk_aabb,
                                         (1,) * nb, trb_pack=ds.trb_pack, sph_pack=ds.sph_pack)
    assert nsb == nb and shift == 0


def test_soft_shadow_light_pack_equals_jax():
    """The soft-shadow light cloud of the 1080p frame: 50 lights in a pack
    padded to 56 rows, every field bit-equal to the JAX build."""
    kw = dict(width=1920, height=1080, scene_backface_culling=True, soft_shadows=True)
    cfg = RenderConfig(**kw)
    scene = Scene.backface_culling(build("semesterbild", cfg), np.array([0.0, 0.0, 1.0]))
    ds = build_device_scene(scene, cfg, device="cpu")
    jcfg = JaxConfig(**kw)
    jscene = JaxScene.backface_culling(jax_model("semesterbild", jcfg), np.array([0.0, 0.0, 1.0]))
    ref_fields, ref_static = _jax_arrays(jax_build(jscene, jcfg))
    assert ds.n_lights == 50 and tuple(ds.light_pack.shape) == (56, 8)
    assert not ds.light_pack[50:].any()
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ds, name).numpy(), ref_fields[name], err_msg=name)
    for name in STATIC_FIELDS:
        assert getattr(ds, name) == ref_static[name], name


# bench.py:37-59 feature sets, at bench.py's tile size
PLAN_CONFIGS = {
    "default": dict(),
    "anti_aliasing": dict(anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True),
    "soft_shadows": dict(soft_shadows=True),
    "realistic": REALISTIC,
    "extreme": dict(REALISTIC, anti_aliasing_rotation_scale=True,
                    anti_aliasing_randomness=True, extreme_quality=True),
}


@pytest.mark.parametrize("config", sorted(PLAN_CONFIGS))
def test_plan_frame_equals_jax(config):
    """Tile layout, AA offsets and weights of the 1080p frame, bit-equal."""
    from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import plan_frame as jax_plan
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import plan_frame

    kw = dict(width=1920, height=1080, tile_rays=131072, **PLAN_CONFIGS[config])
    got, ref = plan_frame(RenderConfig(**kw)), jax_plan(JaxConfig(**kw))
    for name in ("order", "offsets", "weights"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.pix_per_tile, got.n_tiles) == (ref.pix_per_tile, ref.n_tiles)
    if config == "anti_aliasing":  # 9 deduped samples: 143 tiles of 131067 rays
        assert (got.aa, got.n_tiles, got.pix_per_tile * got.aa) == (9, 143, 131067)
    elif config in ("default", "soft_shadows", "realistic"):
        assert (got.aa, got.n_tiles, got.pix_per_tile) == (1, 16, 131072)
