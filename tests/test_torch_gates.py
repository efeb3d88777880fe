"""PyTorch port: the shadow scan's two switches, PRIME_GATE and SORT_GATE
(ops/kernels.py, csrc/rt_light.cuh), against the JAX package's
(pallas_kernels.py:1139, 1167), on the CPU.

* The order table: `kernels.chunk_block_order` equals JAX's
  `_chunk_block_order` on three scenes built through both packages from the
  same seeds: the 1080p semesterbild stand-in under soft_shadows (50
  lights), the scene of tests/test_prime_gate.py (17 lights, two Morton
  clusters) and the 235-block cloud under extreme_quality (140 lights).
* The flags: the JAX package's environment names and defaults (a process
  per setting, since both modules read them when imported).
* Where they act: over a table of (n_lights, nb, n_trans_blocks),
  `kernels.gate_switches` says a switch acts exactly where tracing JAX's
  light kernel builds its order table (SORT) or its prime (PRIME).
* The three wrappers on the CPU (their plain twins: the switches leave
  every bit as it is) against the JAX kernels in interpret mode on the
  PRIME_GATE scene, each switch on and off, both packages' switches set
  alike: the traced-colour bar (rtol 2e-5, atol 2e-6,
  tests/test_pallas_kernels.py:83-84), identical child masks and budgets.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import pallas_kernels as PK
from hslu_i.ba_raytracing.f2501_raytracer_tpu.materials import Material as JaxMaterial
from hslu_i.ba_raytracing.f2501_raytracer_tpu.materials import (
    TransmissionProperties as JaxTransmission,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu.scene.builder import Scene as JaxScene
from hslu_i.ba_raytracing.f2501_raytracer_tpu.scene.builder import TriangleData as JaxTriangle
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig, build_device_scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build, triangle_cloud
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness import (
    GATE_SETTINGS,
    node_state,
    stack_scene,
    with_gates,
)
from test_prime_gate import _cloud_scene as jax_stack_scene

AIR = 1.000293
BAR = dict(rtol=2e-5, atol=2e-6)


def _jax_cloud(jcfg, n=15000, edge_sigma=0.0022, glass_share=0.1, seed=7):
    """The JAX package's semesterbild plus the cloud of
    triangle_cloud.build_scene (its defaults), drawn the same way from the
    same seed."""
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


def _scenes(name):
    """(JAX device scene, the port's own build) of one of the three scenes."""
    if name == "stand-in":
        kw = dict(width=1920, height=1080, soft_shadows=True)
        jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
        return jax_build(jax_model("semesterbild", jcfg), jcfg), build_device_scene(
            build("semesterbild", cfg), cfg, device="cpu")
    if name == "stack":
        kw = dict(width=32, height=16, triangle_block=64)
        jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
        return jax_build(jax_stack_scene(), jcfg), build_device_scene(stack_scene(), cfg,
                                                                       device="cpu")
    # as a renderer with scene_backface_culling builds it (harness.gate_cloud)
    kw = dict(width=1920, height=1080, triangle_block=64, extreme_quality=True)
    jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
    view = np.array([0.0, 0.0, 1.0])
    return (jax_build(JaxScene.backface_culling(_jax_cloud(jcfg), view), jcfg),
            build_device_scene(Scene.backface_culling(triangle_cloud.build_scene(cfg, n=15000),
                                                      view), cfg, device="cpu"))


@pytest.mark.parametrize("name, n_lights, nb", [
    ("stand-in", 50, 2), ("stack", 17, 4), ("cloud", 140, 235)])
def test_chunk_block_order_matches_jax(name, n_lights, nb):
    jds, tds = _scenes(name)
    assert tds.n_lights == jds.n_lights == n_lights and tds.tri_blk_pack.shape[0] == nb
    assert tds.n_trans_blocks == jds.n_trans_blocks < nb
    for f in ("light_pack", "tri_blk_aabb"):
        np.testing.assert_array_equal(getattr(tds, f).numpy(), np.asarray(getattr(jds, f)))
    ref = np.asarray(PK._chunk_block_order(jds.light_pack, jds.tri_blk_aabb, jds.n_lights,
                                           jds.n_trans_blocks))
    got = kernels.chunk_block_order(tds.light_pack, tds.tri_blk_aabb, tds.n_lights,
                                    tds.n_trans_blocks)
    assert got.dtype == torch.int32 and got.shape == (-(-n_lights // 8), nb - tds.n_trans_blocks)
    np.testing.assert_array_equal(got.numpy(), ref)
    # each row is a permutation of the opaque blocks
    assert (np.sort(ref, axis=1) == np.arange(tds.n_trans_blocks, nb)).all()


FLAGS = """
import {module} as m
print(int(m.PRIME_GATE), int(m.SORT_GATE))
"""


@pytest.mark.parametrize("prime_env, sort_env", [
    (None, None), ("0", "1"), ("1", "0"), ("yes", "00")])
def test_flags_read_the_jax_environment(prime_env, sort_env):
    """Both modules read RT_PRIME_GATE and RT_SORT_GATE when imported: off
    when unset or "0", on for anything else."""
    env = {k: v for k, v in os.environ.items() if k not in ("RT_PRIME_GATE", "RT_SORT_GATE")}
    for k, v in (("RT_PRIME_GATE", prime_env), ("RT_SORT_GATE", sort_env)):
        if v is not None:
            env[k] = v
    env["JAX_PLATFORMS"] = "cpu"
    out = {}
    for label, module in (("jax", "hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.pallas_kernels"),
                          ("port", "hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.kernels")):
        run = subprocess.run([sys.executable, "-c", FLAGS.format(module=module)], env=env,
                             capture_output=True, text=True, check=True,
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        out[label] = run.stdout.split()
    expect = [str(int(v is not None and v != "0")) for v in (prime_env, sort_env)]
    assert out["port"] == out["jax"] == expect, out


def _jax_acts(n_lights, nb, n_trans_blocks):
    """(prime, sort): whether tracing JAX's light kernel with both switches
    on reaches the prime (`_pair_flip_opq`) and the order table
    (`_chunk_block_order`)."""
    seen = set()
    orig = PK._chunk_block_order, PK._pair_flip_opq

    def spy(name, fn):
        def call(*a, **kw):
            seen.add(name)
            return fn(*a, **kw)
        return call

    keep = PK.PRIME_GATE, PK.SORT_GATE
    PK._chunk_block_order, PK._pair_flip_opq = spy("sort", orig[0]), spy("prime", orig[1])
    PK.PRIME_GATE = PK.SORT_GATE = True
    try:
        R = 128

        def z(*shape):
            return jnp.zeros(shape, jnp.float32)

        jax.make_jaxpr(lambda *a: PK.pallas_light_shade.__wrapped__(
            z(-(-n_lights // 8) * 8, 8), z(8, 16), z(8, 32), z(nb, 8, 32), z(nb, 8), *a,
            n_lights=n_lights, eps_dist=1e-4, n_trans_blocks=n_trans_blocks, ray_tile=R,
            interpret=True, bigtri_trans_rows=0))(
                z(R, 3), z(R, 3), z(R, 3), z(R, 3), z(R), z(R))
    finally:
        PK._chunk_block_order, PK._pair_flip_opq = orig
        PK.PRIME_GATE, PK.SORT_GATE = keep
    return "prime" in seen, "sort" in seen


@pytest.mark.parametrize("n_lights, nb, n_trans_blocks", [
    (5, 2, 0), (8, 3, 1), (9, 2, 0), (17, 4, 4), (17, 1, 0), (50, 2, 1), (140, 235, 65),
    (1, 1, 1)])
def test_switches_act_where_jax_acts(n_lights, nb, n_trans_blocks):
    assert not any(with_gates(False, False, lambda: kernels.gate_switches(
        n_lights, nb, n_trans_blocks)))
    got = with_gates(True, True, lambda: kernels.gate_switches(n_lights, nb, n_trans_blocks))
    assert got == _jax_acts(n_lights, nb, n_trans_blocks)


@pytest.fixture(scope="module")
def stack():
    """The PRIME_GATE scene through both packages and 128 surface points
    along x as tests/test_prime_gate.py lights it, with seeded node state."""
    cfg = JaxConfig(width=32, height=16, triangle_block=64)
    jds = jax_build(jax_stack_scene(), cfg)
    tds = build_device_scene(stack_scene(), RenderConfig(width=32, height=16, triangle_block=64),
                             device="cpu")
    R = 128
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
    fields["pix"] = np.random.default_rng(48).permutation(R).astype(np.int32)
    static = dict(n_lights=jds.n_lights, eps_dist=float(cfg.camera.epsilon_distance),
                  n_trans_blocks=jds.n_trans_blocks, bigtri_trans_rows=jds.bigtri_trans_rows)
    return jds, tds, fields, static


LIGHT = ("point", "normal", "view", "color", "shininess", "valid")
NODE = LIGHT + ("t", "w", "rior", "budget", "from_refl", "h_httr", "h_met", "h_ior", "h_opac",
                "h_boost")
NODE_STATIC = dict(reflections=True, refractions=True, refl_max=5, refr_max=10,
                   weight_cutoff=1e-3, air=AIR)


def _run_both(kernel, stack, prime, sort):
    """(JAX kernel in interpret mode, the port's wrapper on the CPU) on the
    PRIME_GATE scene, both packages' switches at (prime, sort)."""
    jds, tds, fields, static = stack
    keys, pallas = {"light_shade": (LIGHT, PK.pallas_light_shade),
                    "shade_eval": (NODE, PK.pallas_shade_eval),
                    "shade_eval_rows": (NODE + ("pix",), PK.pallas_shade_eval_rows)}[kernel]
    kw = dict(static) if kernel == "light_shade" else dict(static, **NODE_STATIC)
    keep = PK.PRIME_GATE, PK.SORT_GATE
    PK.PRIME_GATE, PK.SORT_GATE = prime, sort
    try:  # a jit of its own: the switches are read when the kernel is traced
        ref = jax.jit(lambda *a: pallas.__wrapped__(
            jds.light_pack, jds.sph_pack, jds.trb_pack, jds.tri_blk_pack, jds.tri_blk_aabb, *a,
            ray_tile=128, interpret=True, **kw))(*[jnp.asarray(fields[k]) for k in keys])
    finally:
        PK.PRIME_GATE, PK.SORT_GATE = keep
    kernels.reset_launch_counts()
    got = with_gates(prime, sort, lambda: getattr(kernels, kernel)(
        tds.light_pack, tds.sph_pack, tds.trb_pack, tds.tri_blk_pack, tds.tri_blk_aabb,
        *[torch.from_numpy(fields[k]) for k in keys], **kw))
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twin
    return ref, got


def _flat(out):
    items = []
    for x in out:
        items += [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
    return [np.asarray(x) for x in items]


@pytest.mark.parametrize("prime, sort", GATE_SETTINGS, ids=["off", "prime", "sort", "both"])
@pytest.mark.parametrize("kernel", ["light_shade", "shade_eval", "shade_eval_rows"])
def test_wrappers_match_jax_under_the_switches(stack, kernel, prime, sort):
    """Each wrapper against the JAX kernel with the same switches: in the
    scene the switches act (17 lights, four blocks, all opaque)."""
    jds, tds, fields, static = stack
    assert with_gates(True, True, lambda: kernels.gate_switches(
        tds.n_lights, tds.tri_blk_pack.shape[0], tds.n_trans_blocks)) == (True, True)
    ref, got = _run_both(kernel, stack, prime, sort)
    ref, got = _flat(ref), _flat(got)
    assert len(ref) == len(got)
    if kernel == "light_shade":
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **BAR)
        x = fields["point"][:, 0]
        umbra = ref[0][(x > 0.22) & (x < 0.28)]
        lit = ref[0][(x > 0.6) & (x < 0.9)]
        assert umbra.mean() < 0.5 * lit.mean() and lit.mean() > 0  # the grid's umbra
        return
    if kernel == "shade_eval_rows":  # contrib, rows and masks of each child
        contrib, rfl, rfl_m, rfr, rfr_m = ref
        np.testing.assert_array_equal(got[2], rfl_m)
        np.testing.assert_array_equal(got[4], rfr_m)
        np.testing.assert_allclose(got[0], contrib, **BAR)
        np.testing.assert_allclose(got[1][rfl_m], rfl[rfl_m], **BAR)
        np.testing.assert_allclose(got[3][rfr_m], rfr[rfr_m], **BAR)
        assert rfl_m.any() and rfr_m.any()
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
