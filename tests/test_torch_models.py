"""PyTorch port: the scene zoo's `test_scene` and `test_text` builders (the
port's copies of the JAX package's models) give the reference's counts
(tests/test_models.py:34-50), and their device scenes equal the JAX
package's arrays exactly. Without `RAYTRACER_REF_DATA` both packages build
test_text from the same procedural stand-in for the OBJ mesh."""

from __future__ import annotations

import numpy as np
import pytest

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.scene.builder import Scene as JaxScene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig, build_device_scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import SCENES, build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.device import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
)

REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)


def test_test_scene_counts():
    s = build("test_scene", RenderConfig(width=100, height=80))
    assert len(s.scene_objects.spheres) == 4
    # 3 free triangles + 7 bounded planes x 12
    assert len(s.scene_objects.triangles) == 3 + 7 * 12
    assert len(s.scene_lights) == 6


def test_test_text_counts():
    s = build("test_text", RenderConfig(width=100, height=80))
    assert len(s.scene_lights) == 2
    assert len(s.scene_objects.triangles) > 0
    assert len(s.scene_objects.spheres) == 0


def test_zoo_names_the_jax_scenes():
    from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import SCENES as JAX_SCENES

    assert set(JAX_SCENES) <= set(SCENES)


@pytest.mark.parametrize("name,feats", [
    ("test_scene", {}), ("test_scene", dict(REALISTIC, soft_shadows=True)),
    ("test_text", REALISTIC),
])
def test_device_scene_equals_jax(name, feats):
    kw = dict(width=64, height=48, scene_backface_culling=True, **feats)
    jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
    ref = jax_build(JaxScene.backface_culling(jax_model(name, jcfg), np.array([0.0, 0.0, 1.0])),
                    jcfg)
    ds = build_device_scene(Scene.backface_culling(build(name, cfg), np.array([0.0, 0.0, 1.0])),
                            cfg, device="cpu")
    for f in ARRAY_FIELDS:
        got, want = getattr(ds, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(ds, f) == getattr(ref, f), f
    assert ds.n_lights == len(build(name, cfg).scene_lights) * cfg.point_light_multiplicator
