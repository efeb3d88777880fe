"""PyTorch port: `light_shade` (CPU, through its plain twin) against the JAX
`pallas_light_shade` kernel in interpret mode, on the same hit fields.

Hit fields come from the JAX cast of camera rays plus seeded random rays
(parked like the trace parks missed lanes). Both packages get the same numpy
arrays. Scenes: tests/scenes.py `mixed_scene` and semesterbild, each with
its point lights (semesterbild: 5; under `high_quality` 95, as in
reference_default and the SIMD build, and under `extreme_quality` 140, as in
the extreme_480x270 cell) and with the soft-shadow light cloud
(semesterbild: 50 lights in a pack padded to 56 rows, so the TPU kernel runs
six full 8-light chunks plus a tail and disables the padding rows, while the
port's kernel and twin loop over the 50 lights; tests/test_torch_light_shade_soft.py).
Bar: direct and specular within rtol 2e-5, atol 2e-6 (the traced-colour
bar, tests/test_pallas_kernels.py:83-84); the f32 sum order over lights
differs.

Knife edges are set apart, at most 0.5% of the rays (the image bar of
tests/test_parity_wavefront.py): rays whose lighting f32 cannot resolve to
the bar, found as the rays where the twin in float32 misses the same twin
in float64 by more than the bar. They are shadow rays that pass a
transmissive sphere near its silhouette: `b*b - 4c` cancels there and the
Fresnel term through the sphere follows `t`, so the last bit of the
discriminant shows; jitted XLA contracts it into a fused multiply-add,
the port does not (ROADMAP.md Queue 3).
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
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.pallas_kernels import pallas_light_shade
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.shading import light_sums
from scenes import mixed_scene
from test_torch_shade_rows import carry

W, H, N_RANDOM = 16, 12, 64


def _hit_fields(cfg, ds, seed):
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    coords = np.stack(
        [px.reshape(-1) * cam.w2s_width, py.reshape(-1) * cam.w2s_height,
         np.zeros(W * H)], axis=-1,
    ).astype(np.float32)
    o = np.concatenate([coords, rng.uniform(0.0, 1.0, (N_RANDOM, 3)).astype(np.float32)])
    d = np.concatenate([
        coords - np.asarray(cam.render_ray_focus, np.float32),
        rng.normal(size=(N_RANDOM, 3)).astype(np.float32),
    ])
    d = (d / np.sqrt((d * d).sum(axis=1, keepdims=True))).astype(np.float32)
    hit = jax_cast_rays(ds, jnp.asarray(o), jnp.asarray(d), False)
    hval = np.asarray(hit.valid)
    f = lambda a: np.array(a, np.float32)  # noqa: E731  (a writable copy)
    return dict(
        point=f(np.where(hval[:, None], np.asarray(hit.point), np.float32(1e9))),
        normal=f(hit.normal), view=f(d), color=f(hit.color),
        shininess=f(hit.shininess), valid=f(hval),
    )


def ill_conditioned(tds, point, normal, view, color, shininess, valid, eps, backface):
    """(R,) bool: rays whose direct or specular light in float32 misses the
    float64 evaluation of the same formulas by more than the colour bar."""
    args = (point, normal, view, color, shininess)
    r32 = light_sums(tds.light_pack, tds.n_lights, tds.sph_pack, tds.trb_pack,
                     tds.tri_blk_pack, *args, valid, eps, backface)
    d = lambda t: t.double()  # noqa: E731
    r64 = light_sums(d(tds.light_pack), tds.n_lights, d(tds.sph_pack), d(tds.trb_pack),
                     d(tds.tri_blk_pack), *map(d, args), valid, eps, backface)
    bad = torch.zeros(valid.shape, dtype=torch.bool)
    for a, b in zip(r32, r64):
        bad |= ~torch.isclose(a.double(), b, rtol=2e-5, atol=2e-6).all(dim=1)
    return bad.numpy()


# semesterbild's quality tiers: (lights, config flags)
QUALITY = {"hq95": (95, dict(high_quality=True)), "xq140": (140, dict(extreme_quality=True))}


def make_setup(name, soft):
    kw = dict(width=W, height=H, soft_shadows=soft, **QUALITY.get(name, (0, {}))[1])
    if name == "mixed":
        cfg = JaxConfig(**kw)
        ds = jax_build(mixed_scene(cfg), cfg)
    else:
        cfg = JaxConfig(triangle_block=64, **kw)
        ds = jax_build(jax_model("semesterbild", cfg), cfg)
    return name, soft, cfg, ds, carry(ds), _hit_fields(cfg, ds, seed=7)


ORDER = ("point", "normal", "view", "color", "shininess", "valid")


def check_light_shade(setup, backface):
    name, soft, cfg, jds, tds, fields = setup
    eps = float(cfg.camera.epsilon_distance)
    static = dict(
        n_lights=jds.n_lights, eps_dist=eps, n_trans_blocks=jds.n_trans_blocks,
        backface_culling=backface, bigtri_trans_rows=jds.bigtri_trans_rows,
    )
    if name == "semesterbild":
        assert (jds.n_lights, jds.light_pack.shape[0]) == ((50, 56) if soft else (5, 8))
    if name in QUALITY:
        assert jds.n_lights == QUALITY[name][0]
    ref = pallas_light_shade(
        jds.light_pack, jds.sph_pack, jds.trb_pack, jds.tri_blk_pack, jds.tri_blk_aabb,
        *[jnp.asarray(fields[k]) for k in ORDER], ray_tile=128, interpret=True, **static,
    )
    ins = [torch.from_numpy(fields[k]) for k in ORDER]
    kernels.reset_launch_counts()
    got = kernels.light_shade(
        tds.light_pack, tds.sph_pack, tds.trb_pack, tds.tri_blk_pack, tds.tri_blk_aabb,
        *ins, **static,
    )
    assert kernels.LAUNCHES["light_shade"] == 0  # CPU tensors: the twin
    edge = ill_conditioned(tds, *ins[:5], ins[5] != 0, eps, backface)
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[~edge], np.asarray(r)[~edge], rtol=2e-5, atol=2e-6)
    direct = np.asarray(ref[0])
    assert (direct.max(axis=1) > 0).sum() > 0.25 * direct.shape[0]


@pytest.fixture(scope="module", params=["mixed", "semesterbild", *QUALITY])
def setup(request):
    return make_setup(request.param, soft=False)


@pytest.mark.parametrize("backface", [False, True])
def test_light_shade_twin_matches_pallas(setup, backface):
    check_light_shade(setup, backface)
