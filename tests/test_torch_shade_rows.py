"""PyTorch port: `shade_eval_rows` (CPU, through its plain twin) against the
JAX `pallas_shade_eval_rows` kernel in interpret mode, on the same hit
fields.

Hit fields come from the JAX cast of camera rays plus seeded random rays
(parked like the trace parks missed lanes); the node state (weights, media,
depth budgets, reflection flags, pixel ids) is drawn from a seeded numpy
generator. Both packages get the same numpy arrays. Bar: identical child
masks; contrib and the rows of spawned children within rtol 2e-5,
atol 2e-6 (the traced-colour bar, tests/test_pallas_kernels.py:83-84).
Rows of children that are not spawned are never read by the pool and are
not compared.
"""

from __future__ import annotations

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
    pallas_shade_eval_rows,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import device_scene_from_arrays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.device import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
)
from scenes import mixed_scene

W, H = 32, 24
AIR = 1.000293


def carry(ds):
    fields = {f: np.asarray(getattr(ds, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(ds, f) for f in STATIC_FIELDS}
    return device_scene_from_arrays(fields, static, device="cpu")


@pytest.fixture(scope="module", params=["mixed", "semesterbild"])
def setup(request):
    kw = dict(width=W, height=H, reflections=True, refractions=True, weight_cutoff=1e-3)
    if request.param == "mixed":
        cfg = JaxConfig(**kw)
        ds = jax_build(mixed_scene(cfg), cfg)
    else:
        cfg = JaxConfig(triangle_block=64, **kw)
        ds = jax_build(jax_model("semesterbild", cfg), cfg)
    cam = cfg.camera
    rng = np.random.default_rng(11)
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    coords = np.stack(
        [px.reshape(-1) * cam.w2s_width, py.reshape(-1) * cam.w2s_height,
         np.zeros(W * H)], axis=-1,
    ).astype(np.float32)
    o = np.concatenate([coords, rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32)])
    d = np.concatenate([
        coords - np.asarray(cam.render_ray_focus, np.float32),
        rng.normal(size=(256, 3)).astype(np.float32),
    ])
    d = (d / np.sqrt((d * d).sum(axis=1, keepdims=True))).astype(np.float32)
    R = o.shape[0]
    hit = jax_cast_rays(ds, jnp.asarray(o), jnp.asarray(d), False)
    hval = np.asarray(hit.valid)
    point = np.where(hval[:, None], np.asarray(hit.point), np.float32(1e9))
    f = lambda a: np.array(a, np.float32)  # noqa: E731  (a writable copy)
    fields = dict(
        point=f(point), normal=f(hit.normal), view=f(d), color=f(hit.color),
        shininess=f(hit.shininess), valid=f(hval), t=f(hit.t),
        w=f(rng.uniform(0.05, 1.0, (R, 3))),
        rior=f(np.where(rng.random(R) < 0.7, AIR, 1.5)),
        budget=rng.integers(-1, 9, R).astype(np.int32),
        from_refl=f(rng.random(R) < 0.5), h_httr=f(hit.has_trans),
        h_met=f(hit.metallic), h_ior=f(hit.ior), h_opac=f(hit.opacity),
        h_boost=f(hit.boost), pix=rng.permutation(R).astype(np.int32),
    )
    return cfg, ds, carry(ds), fields


def _static(cfg, ds, backface, reflections=True, refractions=True):
    return dict(
        n_lights=ds.n_lights, eps_dist=float(cfg.camera.epsilon_distance),
        n_trans_blocks=ds.n_trans_blocks, backface_culling=backface,
        bigtri_trans_rows=ds.bigtri_trans_rows, reflections=reflections,
        refractions=refractions, refl_max=int(cfg.reflection_max_depth),
        refr_max=int(cfg.refraction_max_depth),
        weight_cutoff=float(cfg.weight_cutoff), air=AIR,
    )


ORDER = ("point", "normal", "view", "color", "shininess", "valid", "t", "w",
         "rior", "budget", "from_refl", "h_httr", "h_met", "h_ior", "h_opac",
         "h_boost", "pix")


def _compare(setup, backface, **children):
    cfg, jds, tds, fields = setup
    static = _static(cfg, jds, backface, **children)
    ref = pallas_shade_eval_rows(
        jds.light_pack, jds.sph_pack, jds.trb_pack, jds.tri_blk_pack,
        jds.tri_blk_aabb, *[jnp.asarray(fields[k]) for k in ORDER],
        ray_tile=128, interpret=True, **static,
    )
    kernels.reset_launch_counts()
    got = kernels.shade_eval_rows(
        tds.light_pack, tds.sph_pack, tds.trb_pack, tds.tri_blk_pack,
        tds.tri_blk_aabb, *[torch.from_numpy(fields[k]) for k in ORDER], **static,
    )
    assert kernels.LAUNCHES["shade_eval_rows"] == 0  # CPU tensors: the twin
    contrib, rfl_rows, rfl_m, rfr_rows, rfr_m = [np.asarray(x) for x in ref]
    g_contrib, g_rfl_rows, g_rfl_m, g_rfr_rows, g_rfr_m = [x.numpy() for x in got]
    np.testing.assert_array_equal(g_rfl_m, rfl_m)
    np.testing.assert_array_equal(g_rfr_m, rfr_m)
    np.testing.assert_allclose(g_contrib, contrib, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(g_rfl_rows[rfl_m], rfl_rows[rfl_m], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(g_rfr_rows[rfr_m], rfr_rows[rfr_m], rtol=2e-5, atol=2e-6)
    return rfl_m, rfr_m, contrib


@pytest.mark.parametrize("backface", [False, True])
def test_shade_rows_twin_matches_pallas(setup, backface):
    rfl_m, rfr_m, contrib = _compare(setup, backface)
    assert rfl_m.any() and rfr_m.any() and np.abs(contrib).max() > 0


def test_shade_rows_single_child_type(setup):
    """Reflections only: the refraction rows and masks are zeros/False."""
    rfl_m, rfr_m, _ = _compare(setup, False, refractions=False)
    assert rfl_m.any() and not rfr_m.any()
