"""PyTorch port: multi-device rendering (`parallel/mesh.py` and the
renderer's `cfg.devices > 1`) on a mesh of 8 CPU entries, against the
port's own one-device calls and against the JAX package's mesh functions on
its 8 virtual CPU devices (tests/conftest.py).

Shapes follow tests/test_multichip.py: `mixed_scene` at 32x16 with
`min_tri_blocks=8` (the stack path: 512 rays), the pool path at 64x64 with
tile_rays 512 and compaction_ratio 2 (8 tiles, W = 256), the renderer at
48x32 (3 tiles over 8 entries: uneven shares, five entries without work).

Bars. Against the port's one-device calls: the same bits; tiles and, on the
stack path, rays are traced independently. Against JAX: the traced-colour
bar of tests/test_torch_trace.py (`valid` identical, colour within rtol
2e-5, atol 2e-6) with knife-edge rays set apart (those whose primary hit
differs between the packages, at most 0.5%); u32 pixels at most one u8
step apart off those rays; the cast at tests/test_torch_cast.py's bar
(`valid` and object index identical, `t` within rtol 2e-6 plus atol 1e-6)
off the rays the port's own cast decides otherwise in float64 (seams); the
renderer's frame at the image bar of tests/test_parity_wavefront.py.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu import parallel as jax_parallel
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.parallel import mesh as jax_mesh
from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import (
    RaytracerRenderer as JaxRenderer,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import graft_entry, parallel
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.trace import (
    trace_rays,
    trace_rays_tiled,
    trace_rays_tiled_u32,
    trace_rays_tiled_u32_gen,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import (
    frame_order_device,
    plan_frame,
)
from scenes import mixed_scene
from test_torch_cast import T_ATOL, T_RTOL, knife_edges
from test_torch_cast import rays as cast_rays_of
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized
from test_torch_renderer import moved_hits, one_torch_thread  # noqa: F401 (autouse)
from test_torch_trace import carry

N = 8
# tests/test_multichip.py:26-29 and :92-95; the pool's host reads every 8
# iterations (loop_chunk) instead of 128, so a drained pool stops sooner
STACK = dict(width=32, height=16, reflections=True, refractions=True, max_nodes=64)
POOL = dict(width=64, height=64, reflections=True, refractions=True, compaction_ratio=2,
            max_nodes=48, tile_rays=512, loop_chunk=8)


def camera_rays(cfg):
    cam = cfg.camera
    px, py = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))
    coords = np.stack([px.reshape(-1) * cam.w2s_width, py.reshape(-1) * cam.w2s_height,
                       np.zeros(px.size)], axis=-1).astype(np.float32)
    return coords, (coords - np.asarray(cam.render_ray_focus, np.float32)).astype(np.float32)


def cpu_mesh(axis="rays"):
    return parallel.make_mesh(devices=["cpu"] * N, axis=axis)


def knife(jds, tds, cfg, o, d):
    """(R,) bool: the rays whose primary hit differs between the packages
    (`moved_hits`) or is one the port's float32 cannot decide (the seam
    rays of `knife_edges`, cast along the port's own normalised
    directions, as `trace_rays` casts them)."""
    dn = normalized(torch.from_numpy(d)).numpy()
    return moved_hits(jds, tds, o, d) | knife_edges(tds, o, dn, cfg.backface_culling)


def assert_colour_bar(color, valid, ref_color, ref_valid, moved):
    """The traced-colour bar against JAX (`valid` identical, colour within
    rtol 2e-5, atol 2e-6): a ray off it must be a knife edge (`moved`: its
    primary hit differs between the packages), and such rays are at most
    0.5%."""
    off = (valid != ref_valid) | ~np.isclose(color, ref_color, rtol=2e-5, atol=2e-6).all(-1)
    assert not (off & ~moved).any(), np.nonzero(off & ~moved)
    assert off.sum() <= 0.005 * off.size, int(off.sum())


@pytest.fixture(scope="module")
def stack_setup():
    jcfg = JaxConfig(**STACK)
    jds = jax_build(mixed_scene(jcfg), jcfg, min_tri_blocks=N)
    o, d = camera_rays(jcfg)
    return jcfg, RenderConfig(**STACK), jds, carry(jds), o, d


@pytest.fixture(scope="module")
def rays_axis_frame(stack_setup):
    _, cfg, _, tds, o, d = stack_setup
    return parallel.render_image_sharded(tds, cfg, torch.from_numpy(o), torch.from_numpy(d),
                                         cpu_mesh())


def test_mesh_rays_axis_has_one_device_bits(stack_setup, rays_axis_frame):
    """`render_image_sharded` joins the shares of `trace_rays_sharded`,
    each the one-device trace of its rays, bit for bit."""
    _, cfg, _, tds, o, d = stack_setup
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    color, valid = trace_rays(tds, cfg, o_t, d_t)
    c_m, v_m = rays_axis_frame
    assert torch.equal(c_m, color) and torch.equal(v_m, valid)
    shards = parallel.trace_rays_sharded(tds, cfg, o_t, d_t, cpu_mesh())
    assert len(shards) == N
    assert torch.equal(torch.cat([c for c, _ in shards]), color)
    assert torch.equal(torch.cat([v for _, v in shards]), valid)
    assert valid.float().mean() > 0.5 and color.max() > 0


def test_mesh_rays_axis_matches_jax(stack_setup, rays_axis_frame):
    jcfg, cfg, jds, tds, o, d = stack_setup
    ref_c, ref_v = jax_parallel.render_image_sharded(
        jds, jcfg, jnp.asarray(o), jnp.asarray(d), jax_parallel.make_mesh(N))
    c, v = rays_axis_frame
    assert_colour_bar(c.numpy(), v.numpy(), np.asarray(ref_c), np.asarray(ref_v),
                      knife(jds, tds, cfg, o, d))


@pytest.fixture(scope="module")
def objs_setup():
    """semesterbild's 128 Morton triangles in blocks of 32, padded to 8
    blocks (4 of them empty), and tests/test_torch_cast.py's rays: camera
    rays and seeded random rays from inside the scene box."""
    jcfg = JaxConfig(width=32, height=24, triangle_block=32)
    jds = jax_build(jax_model("semesterbild", jcfg), jcfg, min_tri_blocks=N)
    o, d = cast_rays_of(jcfg)
    return jds, carry(jds), o, d


@pytest.mark.parametrize("backface", [False, True])
def test_mesh_objs_axis_cast(objs_setup, backface):
    """`cast_nearest_objsharded` on 8 entries (one Morton block each): the
    dense `cast_rays`' bits, and JAX's objs-axis cast at the cast bar."""
    jds, tds, o, d = objs_setup
    assert tds.triangle_blocks == N
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    kernels.reset_launch_counts()
    t, idx, valid = parallel.cast_nearest_objsharded(tds, o_t, d_t, cpu_mesh("objs"), backface)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twins
    hit = cast_rays(tds, o_t, d_t, backface)
    assert torch.equal(valid, hit.valid) and torch.equal(idx, hit.obj_idx)
    assert torch.equal(t, hit.t)
    # hits in two entries' runs of blocks, on big primitives and on spheres
    first = tds.sphere_slots + tds.n_bigtris
    runs = set(((idx[valid & (idx >= first)] - first) // tds.tri_block).tolist())
    assert len(runs) >= 2 and (idx[valid] < first).any()

    ref_t, ref_i, ref_v = (np.asarray(a) for a in jax_parallel.cast_nearest_objsharded(
        jds, jnp.asarray(o), jnp.asarray(d), jax_parallel.make_mesh(N, axis="objs"), backface))
    keep = ~knife_edges(tds, o, d, backface)
    assert (~keep).sum() < 0.005 * keep.size
    np.testing.assert_array_equal(valid.numpy()[keep], ref_v[keep])
    m = ref_v & keep
    np.testing.assert_array_equal(idx.numpy()[m], ref_i[m])
    np.testing.assert_allclose(t.numpy()[m], ref_t[m], rtol=T_RTOL, atol=T_ATOL)


def test_mesh_objs_axis_needs_whole_runs(stack_setup):
    _, _, _, tds, o, d = stack_setup
    mesh3 = parallel.make_mesh(devices=["cpu"] * 3, axis="objs")
    with pytest.raises(ValueError, match="must divide"):
        parallel.cast_nearest_objsharded(tds, torch.from_numpy(o), torch.from_numpy(d), mesh3)


@pytest.fixture(scope="module")
def pool_setup():
    jcfg = JaxConfig(**POOL)
    cfg = RenderConfig(**POOL)
    jds = jax_build(mixed_scene(jcfg), jcfg)
    o, d = camera_rays(jcfg)
    o_tiles, d_tiles = o.reshape(N, 512, 3), d.reshape(N, 512, 3)
    # the pool path on every tile: 512 >= kernel_ray_tile * ratio
    assert 512 >= cfg.kernel_ray_tile * cfg.compaction_ratio
    return jcfg, cfg, jds, carry(jds), o_tiles, d_tiles


def test_mesh_tiles_f32_bits_and_jax(pool_setup):
    jcfg, cfg, jds, tds, o_tiles, d_tiles = pool_setup
    o_t, d_t = torch.from_numpy(o_tiles), torch.from_numpy(d_tiles)
    c_m, v_m, st = parallel.trace_tiles_sharded(tds, cfg, o_t, d_t, cpu_mesh(), with_stats=True)
    c_1, v_1 = trace_rays_tiled(tds, cfg, o_t, d_t)
    assert torch.equal(c_m, c_1) and torch.equal(v_m, v_1) and int(st["dropped"]) == 0

    ref_c, ref_v = jax_mesh.trace_tiles_sharded(
        jds, jcfg, jnp.asarray(o_tiles), jnp.asarray(d_tiles), jax_parallel.make_mesh(N))
    moved = knife(jds, tds, cfg, o_tiles.reshape(-1, 3), d_tiles.reshape(-1, 3))
    assert_colour_bar(c_m.numpy().reshape(-1, 3), v_m.numpy().reshape(-1),
                      np.asarray(ref_c).reshape(-1, 3), np.asarray(ref_v).reshape(-1), moved)


def u8(px):
    return np.stack([(px >> s) & 0xFF for s in (16, 8, 0)], -1).astype(np.int16)


def test_mesh_tiles_u32_bits_and_jax(pool_setup):
    jcfg, cfg, jds, tds, o_tiles, d_tiles = pool_setup
    o_t, d_t = torch.from_numpy(o_tiles), torch.from_numpy(d_tiles)
    w = torch.ones(1)  # no AA: one unit-weight sample a pixel
    u_m, dr_m = parallel.trace_tiles_sharded_u32(tds, cfg, o_t, d_t, w, cpu_mesh())
    u_1, dr_1 = trace_rays_tiled_u32(tds, cfg, o_t, d_t, w)
    assert torch.equal(u_m, u_1) and torch.equal(dr_m, dr_1)
    assert dr_m.shape == (N,) and int(dr_m.sum()) == 0

    ref_u, ref_dr = jax_mesh.trace_tiles_sharded_u32(
        jds, jcfg, jnp.asarray(o_tiles), jnp.asarray(d_tiles), jnp.ones((1,), jnp.float32),
        jax_parallel.make_mesh(N))
    assert int(np.asarray(ref_dr).sum()) == 0
    # a colour within the traced-colour bar rounds to at most one u8 step
    got, ref = u_m.numpy().reshape(-1), np.asarray(ref_u).astype(np.int64).reshape(-1)
    moved = knife(jds, tds, cfg, o_tiles.reshape(-1, 3), d_tiles.reshape(-1, 3))
    off = got != ref
    step = np.abs(u8(got) - u8(ref)).max(-1)
    bad = off & ~moved & ((step > 1) | ((got == 0) != (ref == 0)))
    assert not bad.any(), np.nonzero(bad)
    assert off.sum() <= 0.005 * off.size, int(off.sum())


def test_mesh_tiles_u32_gen_uneven_shares(pool_setup):
    """Device-built rays over 8 tiles on 3 entries (shares 3, 3, 2): the
    one-device bits."""
    _, cfg, _, tds, _, _ = pool_setup
    plan = plan_frame(cfg)
    assert plan.n_tiles == N
    order, offs = frame_order_device(cfg, plan, N, "cpu")
    w = torch.from_numpy(plan.weights)
    mesh3 = parallel.make_mesh(devices=["cpu"] * 3)
    reps = parallel.shard_scene(tds, mesh3)
    assert reps[0] is reps[1] is reps[2]  # one copy per device
    u_m, dr_m = parallel.trace_tiles_sharded_u32_gen(reps, cfg, order, offs, w, mesh3,
                                                      n_tiles=N)
    u_1, dr_1 = trace_rays_tiled_u32_gen(tds, cfg, order, offs, w, n_tiles=N)
    assert torch.equal(u_m, u_1) and torch.equal(dr_m, dr_1)


# tests/test_multichip.py:262-266, at 48x32: 3 tiles of 512 rays
FRAME = dict(width=48, height=32, reflections=True, refractions=True, compaction_ratio=2,
             max_nodes=48, tile_rays=512, loop_chunk=8, device_encode=True)
FRAME_MODES = {
    "u32": dict(),
    "u32_host_rays": dict(device_ray_gen=False),
    "u32_fetch_taper": dict(fetch_groups=4, fetch_taper=True),
    "f32": dict(device_encode=False),
}


@pytest.fixture(scope="module")
def frame_scene():
    jcfg = JaxConfig(**FRAME)
    jds = jax_build(mixed_scene(jcfg), jcfg)
    return jds, carry(jds)


@pytest.mark.parametrize("mode", sorted(FRAME_MODES))
def test_mesh_renderer_frame_has_one_device_bits(frame_scene, mode):
    _, tds = frame_scene
    cfg = RenderConfig(**dict(FRAME, **FRAME_MODES[mode]))
    r1 = RaytracerRenderer(cfg, device="cpu")
    r8 = RaytracerRenderer(dataclasses.replace(cfg, devices=N), device="cpu")
    assert r8.mesh is not None and len(r8.mesh) == N and r8.device == torch.device("cpu")
    b1, b8 = r1.render_device(tds), r8.render_device(tds)
    assert np.array_equal(b8.valid, b1.valid) and b1.valid.mean() > 0.5
    assert np.array_equal(b8.color.view(np.int32), b1.color.view(np.int32))
    assert r8.last_dropped == r1.last_dropped == 0


def test_mesh_renderer_frame_matches_jax_mesh(frame_scene):
    jds, tds = frame_scene
    jcfg = JaxConfig(**FRAME, devices=N, use_pallas=False)
    ref = JaxRenderer(jcfg).render(mixed_scene(jcfg))
    got = RaytracerRenderer(RenderConfig(**FRAME, devices=N), device="cpu").render_device(tds)
    n = got.valid.size
    assert ref.valid.mean() > 0.5
    assert (got.valid != ref.valid).sum() < 0.005 * n
    off = np.abs(got.color - ref.color).max(axis=-1) > 2e-3
    assert off.sum() < 0.005 * n, int(off.sum())


def test_mesh_asks_for_cards_it_has(monkeypatch):
    """No fallback: a mesh of more cards than the host has raises, through
    make_mesh and through the renderer's default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="this host has 1"):
        parallel.make_mesh(2)
    with pytest.raises(RuntimeError, match="this host has 1"):
        RaytracerRenderer(RenderConfig(width=8, height=4, devices=2))
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        parallel.make_mesh(devices=["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="this host has 0"):
        parallel.make_mesh()
    with pytest.raises(ValueError, match="3 devices listed"):
        RaytracerRenderer(RenderConfig(width=8, height=4, devices=2), device=["cpu"] * 3)
    mesh = parallel.make_mesh(devices=["cpu"] * 3, axis="objs")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.axis_names == ("objs",)


def test_graft_entry_dryrun_multichip_on_cpu(capsys):
    graft_entry.dryrun_multichip(N, device="cpu")
    assert f"dryrun_multichip({N})" in capsys.readouterr().out


def test_semesterbild_example_writes_png(tmp_path):
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.examples import semesterbild
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output import read_png

    out = tmp_path / "small.png"
    # the `default` preset: the lighting-only path keeps 228x190 on the
    # CPU twins to seconds
    semesterbild.main(["--small", "--preset", "default", "--device", "cpu", "--out", str(out)])
    png = read_png(str(out))
    assert png.shape == (190, 228, 3) and png.any()


def test_launch_counts_every_launch_from_many_threads(monkeypatch):
    """`kernels._launch` from more threads than cores at a short switch
    interval (a mesh launches from a thread per entry): no launch count is
    lost. A launch whose tensors are not on the current device raises."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(kernels, "_fn", lambda name: lambda *args: 0)  # no library here
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0}))
    dev = torch.device("cuda", 0)

    def launches(_):
        for _ in range(500):
            kernels._launch(dev, "light_shade")

    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as pool:
            for f in [pool.submit(launches, i) for i in range(32)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.LAUNCHES["light_shade"] == 32 * 500
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        kernels._launch(torch.device("cuda", 1), "light_shade")
    kernels.reset_launch_counts()
