"""PyTorch port: the shadow scan of the three shading wrappers (#5
`shade_eval`, #6 `shade_eval_rows`, #7 `light_shade`; csrc/rt_light.cuh on
the card, their plain twins here) against the JAX kernels in interpret mode,
on scenes whose lit shadow scans cross opaque Morton blocks:

* `stack`: the two-cluster stack scene (utils/harness.py::stack_scene, JAX
  tests/test_prime_gate.py::_cloud_scene): 17 lights, four opaque blocks on
  one shadow column, 128 surface points along x under it; backface culling
  off and on;
* `cloud50`, `cloud95`, `cloud140`: semesterbild plus 3,000 small triangles
  in blocks of 64 (triangle_cloud.build_scene; 49 blocks, 27 of them
  opaque) under the light clouds of `soft_shadows`, `high_quality` and
  `extreme_quality`, where most lit shadow scans cross opaque blocks and
  many end in one: the storage-order walk and its first-opaque-hit exit
  (tests/test_torch_shadow_scan_cloud.py, a file of its own so that test
  workers that take a file each share the two out).

Semesterbild alone under 95 and 140 lights is held by
tests/test_torch_light_shade.py and tests/test_torch_shade_rows.py. Each
scene is built through both packages from the same seeds (light packs and
block boxes identical). Inputs: the stack scene's points with seeded node
state; on the cloud the hits of 128 rays (camera and seeded random rays)
cast by the JAX package, parked like the trace parks missed lanes. Bar: the
traced-colour bar (rtol 2e-5, atol 2e-6, tests/test_pallas_kernels.py:83-84)
on direct and specular light, contrib and the rows or fields of spawned
children; identical child masks and budgets.
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
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import pallas_kernels as PK
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    cast_rays as jax_cast_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.scene.builder import TriangleData as JaxTriangle
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig, build_device_scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import triangle_cloud
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness import (
    LIGHT_FEATURES,
    node_state,
    stack_scene,
)
from test_prime_gate import _cloud_scene as jax_stack_scene
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)

AIR = 1.000293
BAR = dict(rtol=2e-5, atol=2e-6)
R = 128
CLOUD = dict(n=3000, edge_sigma=0.03, glass_share=0.1, seed=7)
# the light count of each cloud
LIGHTS = {"cloud50": 50, "cloud95": 95, "cloud140": 140}


def _jax_cloud(jcfg, n, edge_sigma, glass_share, seed):
    """The JAX package's semesterbild plus the cloud of
    triangle_cloud.build_scene, drawn the same way from the same seed."""
    scene = jax_model("semesterbild", jcfg)
    cam = jcfg.camera
    W, H, D = cam.scene_width, cam.scene_height, cam.scene_depth
    lo = np.array([0.02 * W, 0.02 * H, 0.05 * D], np.float64)
    hi = np.array([0.98 * W, 0.9 * H, 0.8 * D], np.float64)
    rng = np.random.default_rng(seed)
    c = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, edge_sigma, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, edge_sigma, (n, 3)).astype(np.float32)
    glass = c[:, 0] < lo[0] + glass_share * (hi[0] - lo[0])
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


def _stack_fields():
    """128 surface points along x as tests/test_prime_gate.py lights them,
    with seeded node state."""
    x = np.linspace(0.0, 1.0, R, dtype=np.float32)
    fields = dict(
        point=np.stack([x, np.full(R, 0.1, np.float32), np.full(R, 0.5, np.float32)], -1),
        normal=np.tile(np.float32([0.0, 1.0, 0.0]), (R, 1)),
        view=np.tile(np.float32([0.0, 0.0, 1.0]), (R, 1)),
        color=np.tile(np.float32([0.8, 0.7, 0.6]), (R, 1)),
        shininess=np.full((R,), 0.3, np.float32), valid=np.ones((R,), np.float32))
    names = ("t", "w", "rior", "budget", "from_refl", "h_httr", "h_met", "h_ior", "h_opac",
             "h_boost")
    fields.update({k: v.numpy() for k, v in zip(names, node_state(R, 47, "cpu"))})
    return fields


def _hit_fields(cfg, jds, seed):
    """The JAX cast's hits of 64 camera rays through seeded pixels and 64
    seeded random rays, with seeded node state."""
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    n = R // 2
    px, py = rng.integers(0, cfg.width, n), rng.integers(0, cfg.height, n)
    coords = np.stack([px * cam.w2s_width, py * cam.w2s_height, np.zeros(n)], -1)
    o = np.concatenate([coords, rng.uniform(0.0, 1.0, (n, 3))]).astype(np.float32)
    d = np.concatenate([coords - np.asarray(cam.render_ray_focus), rng.normal(size=(n, 3))])
    d = (d / np.sqrt((d * d).sum(axis=1, keepdims=True))).astype(np.float32)
    hit = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), False)
    hval = np.asarray(hit.valid)
    f = lambda a: np.array(a, np.float32)  # noqa: E731  (a writable copy)
    return dict(
        point=f(np.where(hval[:, None], np.asarray(hit.point), np.float32(1e9))),
        normal=f(hit.normal), view=f(d), color=f(hit.color), shininess=f(hit.shininess),
        valid=f(hval), t=f(hit.t), w=f(rng.uniform(0.05, 1.0, (R, 3))),
        rior=f(np.where(rng.random(R) < 0.7, AIR, 1.5)),
        budget=rng.integers(-1, 9, R).astype(np.int32), from_refl=f(rng.random(R) < 0.5),
        h_httr=f(hit.has_trans), h_met=f(hit.metallic), h_ior=f(hit.ior),
        h_opac=f(hit.opacity), h_boost=f(hit.boost))


def _scenes(name):
    """(config, JAX device scene, the port's own build) of scene `name`."""
    if name == "stack":
        kw = dict(width=32, height=16, triangle_block=64)
        jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
        return cfg, jax_build(jax_stack_scene(), jcfg), build_device_scene(
            stack_scene(), cfg, device="cpu")
    kw = dict(width=32, height=24, triangle_block=64, **LIGHT_FEATURES[LIGHTS[name]])
    jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
    return cfg, jax_build(_jax_cloud(jcfg, **CLOUD), jcfg), build_device_scene(
        triangle_cloud.build_scene(cfg, **CLOUD), cfg, device="cpu")


@pytest.fixture(scope="module")
def scene(request):
    name = request.param
    cfg, jds, tds = _scenes(name)
    for f in ("light_pack", "tri_blk_aabb"):
        np.testing.assert_array_equal(getattr(tds, f).numpy(), np.asarray(getattr(jds, f)))
    nb = tds.tri_blk_pack.shape[0]
    assert tds.n_trans_blocks == jds.n_trans_blocks < nb  # some block is opaque
    if name != "stack":
        assert nb == 49 and nb - tds.n_trans_blocks == 27
    fields = _stack_fields() if name == "stack" else _hit_fields(cfg, jds, seed=17)
    fields["pix"] = np.random.default_rng(48).permutation(R).astype(np.int32)
    static = dict(n_lights=jds.n_lights, eps_dist=float(cfg.camera.epsilon_distance),
                  n_trans_blocks=jds.n_trans_blocks, bigtri_trans_rows=jds.bigtri_trans_rows)
    return name, jds, tds, fields, static


LIGHT = ("point", "normal", "view", "color", "shininess", "valid")
NODE = LIGHT + ("t", "w", "rior", "budget", "from_refl", "h_httr", "h_met", "h_ior", "h_opac",
                "h_boost")
NODE_STATIC = dict(reflections=True, refractions=True, refl_max=5, refr_max=10,
                   weight_cutoff=1e-3, air=AIR)


def _run_both(kernel, scene, backface):
    """(JAX kernel in interpret mode, the port's wrapper on the CPU)."""
    _, jds, tds, fields, static = scene
    keys, pallas = {"light_shade": (LIGHT, PK.pallas_light_shade),
                    "shade_eval": (NODE, PK.pallas_shade_eval),
                    "shade_eval_rows": (NODE + ("pix",), PK.pallas_shade_eval_rows)}[kernel]
    kw = dict(static, backface_culling=backface)
    if kernel != "light_shade":
        kw.update(NODE_STATIC)
    ref = pallas(jds.light_pack, jds.sph_pack, jds.trb_pack, jds.tri_blk_pack, jds.tri_blk_aabb,
                 *[jnp.asarray(fields[k]) for k in keys], ray_tile=R, interpret=True, **kw)
    kernels.reset_launch_counts()
    got = getattr(kernels, kernel)(
        tds.light_pack, tds.sph_pack, tds.trb_pack, tds.tri_blk_pack, tds.tri_blk_aabb,
        *[torch.from_numpy(fields[k]) for k in keys], **kw)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twin
    return ref, got


def _flat(out):
    items = []
    for x in out:
        items += [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
    return [np.asarray(x) for x in items]


def points(*cases):
    """test_wrappers_match_jax's parameters: the (scene, backface) cases,
    each with the three kernels."""
    def mark(test):
        test = pytest.mark.parametrize(
            "scene, backface", cases, indirect=["scene"],
            ids=[f"{n}-{'backface' if b else 'both-faces'}" for n, b in cases])(test)
        return pytest.mark.parametrize(
            "kernel", ["light_shade", "shade_eval", "shade_eval_rows"])(test)
    return mark


def check_wrappers(scene, kernel, backface):
    """Wrapper `kernel` against the JAX kernel on `scene`."""
    ref, got = _run_both(kernel, scene, backface)
    ref, got = _flat(ref), _flat(got)
    assert len(ref) == len(got)
    name, _, _, fields, _ = scene
    if kernel == "light_shade":
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **BAR)
        if name == "stack":
            x = fields["point"][:, 0]
            umbra = ref[0][(x > 0.22) & (x < 0.28)]
            lit = ref[0][(x > 0.6) & (x < 0.9)]
            assert umbra.mean() < 0.5 * lit.mean() and lit.mean() > 0  # the grid's umbra
        assert (ref[0].max(axis=1) > 0).any()
        return
    if kernel == "shade_eval_rows":  # contrib, rows and masks of each child
        contrib, rfl, rfl_m, rfr, rfr_m = ref
        np.testing.assert_array_equal(got[2], rfl_m)
        np.testing.assert_array_equal(got[4], rfr_m)
        np.testing.assert_allclose(got[0], contrib, **BAR)
        np.testing.assert_allclose(got[1][rfl_m], rfl[rfl_m], **BAR)
        np.testing.assert_allclose(got[3][rfr_m], rfr[rfr_m], **BAR)
        assert rfl_m.any() and rfr_m.any() and np.abs(contrib).max() > 0
        return
    # shade_eval: contrib, then each child's fields in name order
    np.testing.assert_allclose(got[0], ref[0], **BAR)
    refl = dict(zip(("budget", "d", "mask", "o", "w"), zip(got[1:6], ref[1:6])))
    refr = dict(zip(("budget", "d", "ior", "mask", "o", "w"), zip(got[6:], ref[6:])))
    for child in (refl, refr):
        m = child["mask"][1]
        np.testing.assert_array_equal(child["mask"][0], m)
        np.testing.assert_array_equal(child["budget"][0][m], child["budget"][1][m])
        for k in set(child) - {"mask", "budget"}:
            np.testing.assert_allclose(child[k][0][m], child[k][1][m], err_msg=k, **BAR)
        assert m.any()


@points(("stack", False), ("stack", True))
def test_wrappers_match_jax(scene, kernel, backface):
    check_wrappers(scene, kernel, backface)
