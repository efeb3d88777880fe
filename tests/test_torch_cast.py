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

On every ray but a few the reference's `valid` and object index are the
program's alone, and the port is held to them exactly. The few: when XLA
compiles JAX's cast with fast math (`--xla_cpu_enable_fast_math=true`), its
decision moves on two camera rays of mixed_scene without backface culling
(on three in the triangles-only index space of the Pallas kernel), on the
diagonal seam of the bounded plane's two triangles (u + v = 1
to the last bit), where float32 cannot decide the hit: the port's plain
cast decides them otherwise in float64 than in float32
(`test_reference_cast_decisions_move_with_xla_fast_math`). The rays on which
the reference moves so are left out of the comparison, found by running
JAX's cast in a process of its own with that flag; every other ray is
compared. JAX's `t` follow the host's instruction set as well
(`test_reference_cast_bits_follow_the_host_isa`).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

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


def rays(cfg):
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
    return o, d


@pytest.fixture(scope="module", params=["mixed", "semesterbild"])
def setup(request):
    ds, cfg = _scene(request.param)
    return (ds, carry(ds), *rays(cfg), request.param)


T_RTOL, T_ATOL = 2e-6, 1e-6
SCENES = ("mixed", "semesterbild")
JAX_PATHS = {"pallas_interpret": dict(use_pallas=True, interpret=True), "xla": {}}


def twin_rays(o, d):
    """The rays padded to a multiple of 128 for `pallas_cast_triangles`
    (dead rows at the origin, looking along +z); returns (o, d, pad)."""
    pad = (-o.shape[0]) % 128
    op = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    dp = np.concatenate([d, np.tile(np.float32([0, 0, 1]), (pad, 1))])
    return op, dp, pad


def pallas_twin_space(jds, op, dp):
    from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.pallas_kernels import (
        pallas_cast_triangles,
    )

    ref_t, ref_i = pallas_cast_triangles(
        jds.trb_pack, jds.tri_cast_pack, jds.tri_aabb, jds.tri_saabb,
        jnp.asarray(op), jnp.asarray(dp), ray_tile=128, interpret=True,
        sb_sizes=jds.sb_sizes,
    )
    return np.asarray(ref_t), np.asarray(ref_i)


def reference_decisions(name):
    """JAX's hit decisions on `rays` of scene `name`, as arrays keyed
    "{name}-{jax_path}-{backface}-valid" / "-idx" for `cast_rays` and
    "{name}-twin-valid" / "-idx" for `pallas_cast_triangles`."""
    jds, cfg = _scene(name)
    o, d = rays(cfg)
    out = {}
    for path, kw in JAX_PATHS.items():
        for bf in (False, True):
            ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), bf, **kw)
            out[f"{name}-{path}-{bf}-valid"] = np.asarray(ref.valid)
            out[f"{name}-{path}-{bf}-idx"] = np.asarray(ref.obj_idx)
    ref_t, ref_i = pallas_twin_space(jds, *twin_rays(o, d)[:2])
    out[f"{name}-twin-valid"], out[f"{name}-twin-idx"] = np.isfinite(ref_t), ref_i
    return out


def moved(fast, key, valid, idx):
    """(R,) bool: the rays whose decision (valid, object index) JAX takes
    otherwise in `fast`'s process than in this one."""
    fv, fi = fast[key + "-valid"], fast[key + "-idx"]
    return (valid != fv) | (valid & fv & (idx != fi))


_PROBE_HEAD = """
import sys
sys.path[:0] = sys.argv[1:3]
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import torch
import test_torch_cast as T
"""
_FAST_MATH_PROBE = _PROBE_HEAD + """
out = {}
for name in T.SCENES:
    out.update(T.reference_decisions(name))
np.savez(sys.argv[3], **out)
"""


def run_probe(code, xla_flags, path):
    """Run `code` in a Python process of its own whose XLA takes
    `xla_flags`; it writes its results to `path`."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=xla_flags, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", code, tests, os.path.dirname(tests), str(path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def fast_math(tmp_path_factory):
    """`reference_decisions` of both scenes from a process whose XLA
    compiles with fast math."""
    path = tmp_path_factory.mktemp("fast_math") / "decisions.npz"
    return run_probe(_FAST_MATH_PROBE, "--xla_cpu_enable_fast_math=true", path)


def knife_edges(tds, o, d, backface):
    """(R,) bool: the rays whose hit the port's plain cast decides otherwise
    in float64 than in float32."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        return _knife_edges(tds, o, d, backface, monkeypatch)


def _knife_edges(tds, o, d, backface, monkeypatch):
    monkeypatch.setattr(kernels, "cast_triangles", lambda trb, pack, aabb, saabb, o, d,
                        backface_culling, sb_sizes: kernels.cast_triangles_plain(
                            trb, pack, o, d, backface_culling))
    wide = dataclasses.replace(tds, **{
        f.name: getattr(tds, f.name).double() for f in dataclasses.fields(tds)
        if getattr(getattr(tds, f.name), "dtype", None) == torch.float32})
    f32 = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d), backface)
    f64 = cast_rays(wide, torch.from_numpy(o).double(), torch.from_numpy(d).double(), backface)
    both = f32.valid & f64.valid
    return ((f32.valid != f64.valid) | (both & (f32.obj_idx != f64.obj_idx))).numpy()


def _assert_cast_equal(got, ref, n_spheres, keep):
    """`keep`: the rays compared (all but those the reference was shown to
    decide otherwise under fast math)."""
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid[keep], np.asarray(ref.valid)[keep])
    m = np.asarray(ref.valid) & keep
    idx = np.asarray(ref.obj_idx)
    np.testing.assert_array_equal(got.obj_idx.numpy()[m], idx[m])
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m], rtol=T_RTOL, atol=T_ATOL)
    assert (m & (idx >= n_spheres)).any() and (m & (idx < n_spheres)).any()


@pytest.mark.parametrize("backface", [False, True])
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "xla"])
def test_cast_matches_jax(setup, fast_math, backface, jax_path):
    jds, tds, o, d, name = setup
    ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), backface, **JAX_PATHS[jax_path])
    kernels.reset_launch_counts()
    got = cast_rays(tds, torch.from_numpy(o), torch.from_numpy(d), backface)
    assert kernels.LAUNCHES["cast_triangles"] == 0  # CPU tensors: the twin
    keep = ~moved(fast_math, f"{name}-{jax_path}-{backface}", np.asarray(ref.valid),
                  np.asarray(ref.obj_idx))
    assert (~keep).sum() < 0.005 * keep.size, np.nonzero(~keep)
    _assert_cast_equal(got, ref, tds.sphere_slots, keep)
    # material gather rides the same index; a sphere normal is
    # (point - center) / radius, so the t bar above moves it by up to
    # T_ATOL / radius (radius 0.07 in semesterbild)
    m = got.valid.numpy() & keep
    np.testing.assert_array_equal(got.color.numpy()[m], np.asarray(ref.color)[m])
    np.testing.assert_allclose(
        got.normal.numpy()[m], np.asarray(ref.normal)[m], rtol=1e-5, atol=5e-5
    )


def test_reference_cast_decisions_move_with_xla_fast_math(setup, fast_math):
    """The rays on which JAX's decision moves under fast math are knife
    edges of the port's own float32 (decided otherwise in float64); on
    mixed_scene without backface culling there are some, on a host with
    fused multiply-adds."""
    jds, tds, o, d, name = setup
    n_moved = 0
    for bf in (False, True):
        edge = knife_edges(tds, o, d, bf)
        assert edge.sum() < 0.005 * edge.size, int(edge.sum())
        for path, kw in JAX_PATHS.items():
            ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), bf, **kw)
            mv = moved(fast_math, f"{name}-{path}-{bf}", np.asarray(ref.valid),
                       np.asarray(ref.obj_idx))
            assert not (mv & ~edge).any(), np.nonzero(mv & ~edge)
            n_moved += int(mv.sum())
    cpuinfo = open("/proc/cpuinfo").read() if os.path.exists("/proc/cpuinfo") else ""
    if name == "mixed" and " fma" in cpuinfo:
        assert n_moved > 0


_ISA_PROBE = _PROBE_HEAD + """
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import cast_rays as jax_cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
jds, cfg = T._scene("mixed")
o, d = T.rays(cfg)
ref = jax_cast_rays(jds, jnp.asarray(o), jnp.asarray(d), False, use_pallas=True, interpret=True)
got = cast_rays(T.carry(jds), torch.from_numpy(o), torch.from_numpy(d), False)
np.savez(sys.argv[3], jax_t=np.asarray(ref.t), jax_valid=np.asarray(ref.valid),
         port_t=got.t.numpy(), port_valid=got.valid.numpy())
"""


def test_reference_cast_bits_follow_the_host_isa(tmp_path):
    """The same JAX cast (Pallas interpret mode, mixed_scene) in two
    processes whose XLA targets two instruction sets of this host, SSE4.2
    (no fused multiply-add) and AVX2 (with it): JAX's `t` differ within the
    bar, the port's are the same bits. So JAX's last bits are the host's,
    not the program's."""
    cpuinfo = open("/proc/cpuinfo").read() if os.path.exists("/proc/cpuinfo") else ""
    if " avx2" not in cpuinfo:
        pytest.skip("needs an x86 host with AVX2")
    a, b = (run_probe(_ISA_PROBE, f"--xla_cpu_max_isa={isa}", tmp_path / f"{isa}.npz")
            for isa in ("SSE4_2", "AVX2"))
    np.testing.assert_array_equal(a["port_t"], b["port_t"])
    np.testing.assert_array_equal(a["port_valid"], b["port_valid"])
    fin = a["jax_valid"] & b["jax_valid"]
    assert (a["jax_t"][fin] != b["jax_t"][fin]).any()
    np.testing.assert_allclose(a["jax_t"][fin], b["jax_t"][fin], rtol=T_RTOL, atol=T_ATOL)


def test_cast_twin_index_space_matches_pallas(setup, fast_math):
    """The twin returns the Pallas kernel's local index space: big primitive
    p -> p, Morton slot -> P_pad + b*B + c, miss -> (+inf, 2^31-1)."""
    jds, tds, o, d, name = setup
    op, dp, pad = twin_rays(o, d)
    ref_t, ref_i = pallas_twin_space(jds, op, dp)
    t, i = kernels.cast_triangles_plain(
        tds.trb_pack, tds.tri_cast_pack, torch.from_numpy(op), torch.from_numpy(dp)
    )
    keep = ~moved(fast_math, f"{name}-twin", np.isfinite(ref_t), ref_i)
    assert (~keep).sum() < 0.005 * keep.size, np.nonzero(~keep)
    np.testing.assert_array_equal(np.isfinite(t.numpy())[keep], np.isfinite(ref_t)[keep])
    np.testing.assert_array_equal(i.numpy()[keep], ref_i[keep])
    fin = np.isfinite(ref_t) & keep
    np.testing.assert_allclose(t.numpy()[fin], ref_t[fin], rtol=T_RTOL, atol=T_ATOL)
