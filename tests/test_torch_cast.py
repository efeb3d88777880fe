"""PyTorch port: `cast_rays` (CPU, through the plain twin of the
`cast_triangles` kernel) against the JAX `cast_rays`, both through its
Pallas kernel (interpret mode) and through its plain XLA path.

The scene is built once by the JAX package and carried across as numpy
(`device_scene_from_arrays`), so both packages see the same arrays. Bar:
identical `valid` and object index (tests/test_pallas_kernels.py:42-45),
and `t` within rtol 2e-6 plus atol 1e-6 (scene units) instead of that
file's rtol 1e-6. The reason: jitted
XLA on the CPU contracts a*b+c into fused multiply-adds, the port never
does (PyTorch's CPU ops are separate; the CUDA kernels build with
--fmad=false), and the sphere root and the Woop transform amplify that
last-bit difference by cancellation. JAX's two paths share one compiler
and agree at 1e-6; against a float64 evaluation of the same packs, JAX and
the port have the same worst error (7.8e-5 relative on one semesterbild
ray). The cancellation error is absolute in scene units (it comes from
O(1) terms), hence the atol for the short random rays.
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
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import device_scene_from_arrays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.device import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
)
from scenes import mixed_scene

W, H = 32, 24


def carry(ds):
    fields = {f: np.asarray(getattr(ds, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(ds, f) for f in STATIC_FIELDS}
    return device_scene_from_arrays(fields, static, device="cpu")


def _scene(name):
    # semesterbild at 1080p-regime block size (B=64, two Morton blocks with a
    # superblock) exercises the block scan; mixed_scene has no Morton
    # triangles worth the name but spheres, big triangles and transmission
    if name == "mixed":
        cfg = JaxConfig(width=W, height=H)
        return jax_build(mixed_scene(cfg), cfg), cfg
    cfg = JaxConfig(width=W, height=H, triangle_block=64)
    return jax_build(jax_model("semesterbild", cfg), cfg), cfg


@pytest.fixture(scope="module", params=["mixed", "semesterbild"])
def setup(request):
    ds, cfg = _scene(request.param)
    cam = cfg.camera
    rng = np.random.default_rng(7)
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    coords = np.stack(
        [px.reshape(-1) * cam.w2s_width, py.reshape(-1) * cam.w2s_height,
         np.zeros(W * H)], axis=-1,
    ).astype(np.float32)
    # camera rays plus seeded random rays from inside the scene box
    # (secondary-ray-like directions, including ones that travel backwards)
    o_rand = rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32)
    d_rand = rng.normal(size=(256, 3)).astype(np.float32)
    o = np.concatenate([coords, o_rand])
    d = np.concatenate([coords - np.asarray(cam.render_ray_focus, np.float32), d_rand])
    d = (d / np.sqrt((d * d).sum(axis=1, keepdims=True))).astype(np.float32)
    return ds, carry(ds), o, d


T_RTOL, T_ATOL = 2e-6, 1e-6


def _assert_cast_equal(got, ref, n_spheres):
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    m = np.asarray(ref.valid)
    idx = np.asarray(ref.obj_idx)
    np.testing.assert_array_equal(got.obj_idx.numpy()[m], idx[m])
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m], rtol=T_RTOL, atol=T_ATOL)
    assert (m & (idx >= n_spheres)).any() and (m & (idx < n_spheres)).any()


@pytest.mark.parametrize("backface", [False, True])
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "xla"])
def test_cast_matches_jax(setup, backface, jax_path):
    jds, tds, o, d = setup
    kw = dict(use_pallas=True, interpret=True) if jax_path == "pallas_interpret" else {}
    ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), backface, **kw)
    kernels.reset_launch_counts()
    got = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d), backface)
    assert kernels.LAUNCHES["cast_triangles"] == 0  # CPU tensors: the twin
    _assert_cast_equal(got, ref, tds.sphere_slots)
    # material gather rides the same index; a sphere normal is
    # (point - center) / radius, so the t bar above moves it by up to
    # T_ATOL / radius (radius 0.07 in semesterbild)
    m = got.valid.numpy()
    np.testing.assert_array_equal(got.color.numpy()[m], np.asarray(ref.color)[m])
    np.testing.assert_allclose(
        got.normal.numpy()[m], np.asarray(ref.normal)[m], rtol=1e-5, atol=5e-5
    )


def test_cast_twin_index_space_matches_pallas(setup):
    """The twin returns the Pallas kernel's local index space: big primitive
    p -> p, Morton slot -> P_pad + b*B + c, miss -> (+inf, 2^31-1)."""
    from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.pallas_kernels import (
        pallas_cast_triangles,
    )

    jds, tds, o, d = setup
    R = o.shape[0]
    pad = (-R) % 128
    op = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    dp = np.concatenate([d, np.tile(np.float32([0, 0, 1]), (pad, 1))])
    ref_t, ref_i = pallas_cast_triangles(
        jds.trb_pack, jds.tri_cast_pack, jds.tri_aabb, jds.tri_saabb,
        jnp.asarray(op), jnp.asarray(dp), ray_tile=128, interpret=True,
        sb_sizes=jds.sb_sizes,
    )
    t, i = kernels.cast_triangles_plain(
        tds.trb_pack, tds.tri_cast_pack, torch.from_numpy(op), torch.from_numpy(dp)
    )
    ref_t, ref_i = np.asarray(ref_t), np.asarray(ref_i)
    np.testing.assert_array_equal(np.isfinite(t.numpy()), np.isfinite(ref_t))
    np.testing.assert_array_equal(i.numpy(), ref_i)
    fin = np.isfinite(ref_t)
    np.testing.assert_allclose(t.numpy()[fin], ref_t[fin], rtol=T_RTOL, atol=T_ATOL)
