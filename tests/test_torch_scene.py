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
