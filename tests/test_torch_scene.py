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
