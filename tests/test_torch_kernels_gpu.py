"""PyTorch port on the card: each of the seven CUDA kernels against its plain
twin (the four kernels with a warp per ray also on NaN and parked rays, rays
that start on a block's box, axis-aligned rays, ragged ray counts from 0 to
a tile, one and eight rays per warp, coincident triangles, and run to run;
the occlusion kernels on max_distance <= 0 and empty blocks; shade_eval_rows
bit for bit against shade_eval in both of its forms, with every ray live and
with few; light_shade at ray counts from 0 to a tile and at 95 lights
(the SIMD build's packet path); all of them on
block partitions the JAX package takes: a superblock of more than 32 blocks
and blocks of 48 rows), the pool's chunk commit, and small renders against
the CPU twins (the SIMD build's packet frame among them); each kernel
launched from two host threads at once, each on a stream of its own, and a
mesh of two entries on one card (parallel/mesh.py); the three shading
kernels in every form against their twins where the shadow scans cross
many opaque Morton blocks (the 235-block cloud at 5, 50 and 95 lights, the
two-cluster stack scene).

Needs an NVIDIA GPU and nvcc; every test carries the `gpu` marker and skips
from the `cuda` fixture when there is no card. This file imports neither JAX
nor the JAX test helpers, so on the card (where JAX is not installed) it
runs without the repository's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (
    RaytracerRenderer,
    RenderConfig,
    build_device_scene,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import triangle_cloud
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays, occlude_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.trace import AIR, _commit
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness import (
    PARTITIONS,
    assert_node_bits,
    caught_calls,
    cloud_scene,
    flat,
    node_state,
    same_bits,
    same_occlusion,
    stack_inputs,
)

REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: pytest -m gpu on the card)")
    return torch.device("cuda")


def _scene(dev, **features):
    # the 1080p main-path scene: B = 64, 2 Morton blocks, 48 big triangles
    cfg = RenderConfig(width=1920, height=1080, scene_backface_culling=True,
                       weight_cutoff=1e-3, **(features or REALISTIC))
    scene = Scene.backface_culling(build("semesterbild", cfg), np.array([0.0, 0.0, 1.0]))
    return cfg, build_device_scene(scene, cfg, device=dev)


def _rays(cfg, n, seed):
    rng = np.random.default_rng(seed)
    cam = cfg.camera
    px = rng.integers(0, cfg.width, n)
    py = rng.integers(0, cfg.height, n)
    o = np.stack([px * cam.w2s_width, py * cam.w2s_height, np.zeros(n)], -1).astype(np.float32)
    d = o - np.asarray(cam.render_ray_focus, np.float32)
    # a quarter of the rays start inside the scene and go any way
    k = n // 4
    o[:k] = rng.uniform(0.0, 1.0, (k, 3))
    d[:k] = rng.normal(size=(k, 3))
    d = d / np.sqrt((d * d).sum(1, keepdims=True))
    return o, d.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("backface", [False, True])
def test_cast_kernel_matches_twin(cuda, backface):
    cfg, ds = _scene(cuda)
    o, d = (torch.from_numpy(a).to(cuda) for a in _rays(cfg, 8192, 1))
    args = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb, o, d)
    kernels.reset_launch_counts()
    t, idx = kernels.cast_triangles(*args, backface_culling=backface, sb_sizes=ds.sb_sizes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cast_triangles"] == 1
    t_ref, idx_ref = kernels.cast_triangles_plain(ds.trb_pack, ds.tri_cast_pack, o, d, backface)
    np.testing.assert_array_equal(idx.cpu().numpy(), idx_ref.cpu().numpy())
    fin = torch.isfinite(t_ref)
    assert torch.equal(torch.isfinite(t), fin)
    np.testing.assert_allclose(t[fin].cpu().numpy(), t_ref[fin].cpu().numpy(), rtol=1e-6)


RESIDENT_WIDTHS = (0, 1, 7, 2049, 131072)  # ragged warps and thread blocks; a tile


# shade_eval_rows' three forms (kernels.node_form): a warp per ray, a ray
# per lane, and a warp per ray whose lanes take its lights
NODE_FORMS = (1, 32, kernels.LIGHT_LANES)


def _other_form(monkeypatch, n, form=None):
    """Make the wrappers take the other number of rays per warp for n rays:
    one, or many (a ray per lane in the resident kernels); with `form`, make
    shade_eval_rows take that form of NODE_FORMS at any ray and light
    count."""
    if form is not None:
        monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 0 if form == 32 else 1 << 30)
        monkeypatch.setattr(kernels, "LIGHT_LANES_MIN_LIGHTS",
                            0 if form == kernels.LIGHT_LANES else 1 << 30)
        assert kernels.node_form(n, 1) == form
        return
    one = kernels.rays_per_warp(n) == 1
    monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 0 if one else 1 << 30)
    assert (kernels.rays_per_warp(n) == 1) != one


def _tie_tables(ds, o, d):
    """The cast tables with coincident triangles: the big primitive that the
    most rays hit copied into a Morton slot, and the most-hit Morton triangle
    copied into an earlier and a later slot of its block; the boxes of the
    changed blocks (and their superboxes) grown to the whole scene. Returns
    the tables and (big row, its Morton copy, the earlier copy)."""
    P = ds.trb_pack.shape[0]
    pack, aabb, saabb = ds.tri_cast_pack.clone(), ds.tri_aabb.clone(), ds.tri_saabb.clone()
    _, idx = kernels.cast_triangles_plain(ds.trb_pack, pack, o, d)
    B = pack.shape[1]
    vals, counts = torch.unique(idx[idx < P], return_counts=True)
    p = int(vals[counts.argmax()])
    vals, counts = torch.unique(idx[(idx >= P) & (idx < P + pack.shape[0] * B)], return_counts=True)
    b, c = divmod(int(vals[counts.argmax()]) - P, B)
    c_big = (c + 17) % B
    pack[b, c_big] = ds.trb_pack[p]
    c_early, c_late = (c - 9) % B, (c + 9) % B
    pack[b, c_early] = pack[b, c_late] = pack[b, c]
    starts = np.concatenate([[0], np.cumsum(ds.sb_sizes)])
    g = int(np.searchsorted(starts, b, side="right") - 1)
    for box in (aabb[b], saabb[g]):
        box[0:3], box[3:6] = -1e4, 1e4
    return (pack, aabb, saabb), (p, P + b * B + c_big, P + b * B + min(c_early, c, c_late))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["semesterbild", "ties"])
@pytest.mark.parametrize("backface", [False, True])
def test_cast_kernel_widths_forms_and_ties(cuda, monkeypatch, backface, case):
    """Ray counts from 0 to a tile, one ray per warp and a ray per lane,
    three runs: t and index identical to the twin. `ties`: a big primitive and a Morton
    triangle at the same t keep the big primitive; two slots of one block,
    the lower slot."""
    cfg, ds = _scene(cuda)
    o_all, d_all = _hard_rays(cfg, ds, cuda, 131072, 21)
    tables, same = (ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb), None
    if case == "ties":
        tables, same = _tie_tables(ds, o_all[:4096], d_all[:4096])
    args = (ds.trb_pack, *tables)
    for n in RESIDENT_WIDTHS:
        o, d = o_all[:n].contiguous(), d_all[:n].contiguous()
        kernels.reset_launch_counts()
        t, idx = kernels.cast_triangles(*args, o, d, backface_culling=backface,
                                        sb_sizes=ds.sb_sizes)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["cast_triangles"] == 1
        t_ref, idx_ref = kernels.cast_triangles_plain(ds.trb_pack, tables[0], o, d, backface)
        assert t.shape == (n,) and idx.dtype == torch.int32
        assert torch.equal(idx, idx_ref) and same_bits(t, t_ref), n
        for _ in range(2):
            again = kernels.cast_triangles(*args, o, d, backface_culling=backface,
                                           sb_sizes=ds.sb_sizes)
            assert same_bits(again[0], t) and torch.equal(again[1], idx)
        with monkeypatch.context() as m:
            _other_form(m, n)
            other = kernels.cast_triangles(*args, o, d, backface_culling=backface,
                                           sb_sizes=ds.sb_sizes)
        assert same_bits(other[0], t) and torch.equal(other[1], idx), n
    assert torch.isfinite(t).sum() > 1000 and (~torch.isfinite(t)).any()
    if case == "ties":
        big, big_copy, early = same
        assert (idx == big).any() and not (idx == big_copy).any()
        assert (idx == early).any()


def _shade_inputs(cfg, ds, dev, n, seed):
    """Lighting inputs at the hits of n rays, node state drawn from a seed."""
    o, d = (torch.from_numpy(a).to(dev) for a in _rays(cfg, n, seed))
    R = o.shape[0]
    hit = cast_rays(ds, o, d)
    rng = np.random.default_rng(seed + 1)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    point = torch.where(hit.valid[:, None], hit.point, torch.full_like(hit.point, 1e9))
    f32 = torch.float32
    light = (
        ds.light_pack, ds.sph_pack, ds.trb_pack, ds.tri_blk_pack, ds.tri_blk_aabb,
        point, hit.normal.contiguous(), d, hit.color.contiguous(),
        hit.shininess.contiguous(), hit.valid.to(f32),
    )
    node = (
        hit.t.contiguous(),
        g(rng.uniform(0.05, 1.0, (R, 3)).astype(np.float32)),
        g(np.where(rng.random(R) < 0.7, AIR, 1.5).astype(np.float32)),
        g(rng.integers(-1, 9, R).astype(np.int32)),
        g((rng.random(R) < 0.5).astype(np.float32)),
        hit.has_trans.to(f32), hit.metallic.contiguous(), hit.ior.contiguous(),
        hit.opacity.contiguous(), hit.boost.contiguous(),
    )
    kw = dict(
        n_lights=ds.n_lights, eps_dist=float(cfg.camera.epsilon_distance),
        n_trans_blocks=ds.n_trans_blocks, bigtri_trans_rows=ds.bigtri_trans_rows,
    )
    return light, node, g(rng.permutation(R).astype(np.int32)), kw


def _node_kw(cfg, kw):
    return dict(kw, refl_max=cfg.reflection_max_depth, refr_max=cfg.refraction_max_depth,
                weight_cutoff=cfg.weight_cutoff, air=AIR)


@pytest.mark.gpu
@pytest.mark.parametrize("features", ["hard", "soft"])
def test_light_shade_kernel_matches_twin(cuda, features):
    """5 lights, and the 50-light soft-shadow cloud (56 rows, 6 padding)."""
    cfg, ds = _scene(cuda, **({"soft_shadows": True} if features == "soft" else {}))
    assert ds.n_lights == (50 if features == "soft" else 5)
    light, _, _, kw = _shade_inputs(cfg, ds, cuda, 4099, 4)  # not a multiple of a block
    kernels.reset_launch_counts()
    got = kernels.light_shade(*light, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["light_shade"] == 1
    ref = kernels.light_shade_plain(*light, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6)
    assert (got[0].amax(dim=1) > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("children", [dict(), dict(refractions=False), dict(reflections=False)],
                         ids=["both", "reflection", "refraction"])
def test_shade_eval_kernel_matches_twin(cuda, children):
    cfg, ds = _scene(cuda)
    light, node, _, kw = _shade_inputs(cfg, ds, cuda, 8192, 6)
    kw = dict(_node_kw(cfg, kw), **children)
    kernels.reset_launch_counts()
    contrib, refl, refr = kernels.shade_eval(*light, *node, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shade_eval"] == 1
    c_ref, refl_ref, refr_ref = kernels.shade_eval_plain(*light, *node, **kw)
    np.testing.assert_allclose(contrib.cpu().numpy(), c_ref.cpu().numpy(), rtol=2e-5, atol=2e-6)
    for got, ref in ((refl, refl_ref), (refr, refr_ref)):
        m = ref["mask"].cpu().numpy()
        np.testing.assert_array_equal(got["mask"].cpu().numpy(), m)
        np.testing.assert_array_equal(got["budget"].cpu().numpy()[m], ref["budget"].cpu().numpy()[m])
        for k in set(ref) - {"mask", "budget"}:
            np.testing.assert_allclose(got[k].cpu().numpy()[m], ref[k].cpu().numpy()[m],
                                       rtol=2e-5, atol=2e-6, err_msg=k)
    assert refl["mask"].any() == kw.get("reflections", True)
    assert refr["mask"].any() == kw.get("refractions", True)


@pytest.mark.gpu
def test_commit_is_deterministic(cuda):
    """The pool's chunk commit gives the same bits on every run, with many
    rows per pixel."""
    rng = np.random.default_rng(8)
    n, R = 196608, 1024
    pix = torch.from_numpy(rng.integers(0, R + 1, n)).to(cuda)
    contrib = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)).to(cuda)
    base = torch.from_numpy(rng.uniform(0.0, 1.0, (R + 1, 3)).astype(np.float32)).to(cuda)
    outs = []
    for _ in range(3):
        acc = base.clone()
        _commit(acc, pix, contrib)
        outs.append(acc.cpu())
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = base.cpu().double().index_add_(0, pix.cpu(), contrib.cpu().double())
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=1e-5)


@pytest.mark.gpu
def test_shade_kernel_matches_twin(cuda):
    cfg, ds = _scene(cuda)
    light, node, pix, kw = _shade_inputs(cfg, ds, cuda, 8192, 2)
    args = (*light, *node, pix)
    kw = _node_kw(cfg, kw)
    kernels.reset_launch_counts()
    got = kernels.shade_eval_rows(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shade_eval_rows"] == 1
    ref = kernels.shade_eval_rows_plain(*args, **kw)
    contrib, rfl_rows, rfl_m, rfr_rows, rfr_m = [x.cpu().numpy() for x in got]
    c_ref, rfl_ref, rfl_m_ref, rfr_ref, rfr_m_ref = [x.cpu().numpy() for x in ref]
    np.testing.assert_array_equal(rfl_m, rfl_m_ref)
    np.testing.assert_array_equal(rfr_m, rfr_m_ref)
    np.testing.assert_allclose(contrib, c_ref, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(rfl_rows[rfl_m], rfl_ref[rfl_m], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(rfr_rows[rfr_m], rfr_ref[rfr_m], rtol=2e-5, atol=2e-6)
    assert rfl_m.any() and rfr_m.any()


def _node_scene(dev, scene):
    """(cfg, scene) of the node kernels' tests: the 1080p scene with 5 or 50
    lights, or with extreme's 140 (5 clouds of 28), or the resident cloud,
    whose Morton blocks hold glass."""
    if scene == "cloud":
        cfg, ds = _cloud_scene(dev)
        assert not ds.streaming and ds.n_trans_blocks > 0
    elif scene == "140_lights":
        cfg, ds = _scene(dev, **dict(REALISTIC, extreme_quality=True))
        assert ds.n_lights == 140
    else:
        cfg, ds = _scene(dev, **dict(REALISTIC, soft_shadows=scene == "50_lights"))
        assert ds.n_lights == (50 if scene == "50_lights" else 5)
    return cfg, ds


def _unlit_rows(light, n_lights, every=97):
    """Every `every`-th ray of the lighting inputs `light` moved to a hit
    that faces away from all lights: 1000 units past their centre along
    -z, its normal -z. Returns the inputs and the rays that hit something
    and see no light."""
    pack, point, normal, valid = light[0], light[5].clone(), light[6].clone(), light[10]
    pos = pack[:n_lights, 0:3]
    away = torch.tensor([0.0, 0.0, -1.0], device=point.device)
    point[::every] = pos.mean(0) + 1000.0 * away
    normal[::every] = away
    facing = ((pos[None, :, :] - point[:, None, :]) * normal[:, None, :]).sum(-1) > 0
    return (*light[:5], point, normal, *light[7:]), (valid != 0) & ~facing.any(1)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["5_lights", "50_lights", "140_lights", "cloud"])
def test_shade_rows_kernel_widths_forms_and_bits(cuda, monkeypatch, scene):
    """Ray counts from 0 to a tile and the pool's 3584, in each of the three
    forms (a warp per ray, a ray per lane, the light-lanes form), three runs
    each: the twin's masks and values within its bar, and the bits of
    shade_eval (one thread per ray) on the same inputs: contrib, every child
    field and the masks, rays without a hit and rays that see no light
    included; the cloud adds Morton blocks with glass (the 1080p scene has
    none), 140 lights extreme's light clouds."""
    cfg, ds = _node_scene(cuda, scene)
    light, node, pix, kw = _shade_inputs(cfg, ds, cuda, 131072, 31)
    light, unlit = _unlit_rows(light, ds.n_lights)
    kw = _node_kw(cfg, kw)
    per_ray = (*light[5:], *node, pix)
    for n in (*RESIDENT_WIDTHS, 3584):
        rays = [a[:n].contiguous() for a in per_ray]
        args = (*light[:5], *rays)
        if n > 1000:
            assert unlit[:n].any() and (rays[5] == 0).any()  # valid
        kernels.reset_launch_counts()
        got = kernels.shade_eval_rows(*args, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["shade_eval_rows"] == 1
        lanes = kernels.node_form(n, ds.n_lights) == kernels.LIGHT_LANES
        assert kernels.LAUNCHES[kernels.LIGHT_LANES_LAUNCHES] == int(lanes)
        contrib, rfl, rfl_m, rfr, rfr_m = got
        assert contrib.shape == (n, 3) and rfl.shape == rfr.shape == (n, 16)
        assert_node_bits(got, kernels.shade_eval(*args[:-1], **kw))
        assert torch.equal(rfl[:, 12], rays[-1].float()) and not rfl[:, 13:].any()
        ref = kernels.shade_eval_rows_plain(*args, **kw)
        assert torch.equal(rfl_m, ref[2]) and torch.equal(rfr_m, ref[4])
        for a, b, m in ((contrib, ref[0], None), (rfl, ref[1], rfl_m), (rfr, ref[3], rfr_m)):
            a, b = (a, b) if m is None else (a[m], b[m])
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6)
        for form in NODE_FORMS:
            with monkeypatch.context() as mp:
                _other_form(mp, n, form)
                for _ in range(3):
                    other = kernels.shade_eval_rows(*args, **kw)
                    assert all(same_bits(x, y) for x, y in zip(got, other)), (n, form)
    assert rfl_m.any() and rfr_m.any() and (contrib.amax(1) > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["5_lights", "50_lights", "cloud"])
def test_shade_eval_forms_match_shade_eval_rows(cuda, monkeypatch, scene):
    """shade_eval in both of its forms (a warp per live ray; a ray per lane
    over the list of live rays), at ray counts from 0 to a tile, with every
    ray that hits live and with one in twenty (a late wavefront of the stack
    path): bit for bit the outputs of shade_eval_rows on the same inputs,
    rays without a hit included, and the same bits on a second run."""
    cfg, ds = _node_scene(cuda, scene)
    light, node, pix, kw = _shade_inputs(cfg, ds, cuda, 131072, 33)
    kw = _node_kw(cfg, kw)
    per_ray = [*light[5:], *node, pix]
    sparse = torch.from_numpy(np.random.default_rng(34).random(131072) < 0.05).to(cuda)
    for n in RESIDENT_WIDTHS:
        for thin in (False, True):
            rays = [a[:n].contiguous() for a in per_ray]
            if thin:
                rays[5] = rays[5] * sparse[:n]  # valid
            args = (*light[:5], *rays)
            rows = kernels.shade_eval_rows(*args, **kw)
            for most in (1 << 30, -1):
                monkeypatch.setattr(kernels, "NODE_WARP_MAX_LIVE", most)
                kernels.reset_launch_counts()
                got = kernels.shade_eval(*args[:-1], **kw)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["shade_eval"] == 1
                assert_node_bits(rows, got)
                again = kernels.shade_eval(*args[:-1], **kw)
                assert all(same_bits(x, y) for x, y in zip(flat(got), flat(again))), n
    assert rows[2].any() and rows[4].any()


@pytest.mark.gpu
def test_shade_eval_takes_any_slot_count(cuda, monkeypatch):
    """shade_eval at 2^20 + 37 slots (8193 segments of the list of live
    rays, whose offsets stay in global memory), with every ray that hits
    live and with one in twenty, in both forms: bit for bit the outputs of
    shade_eval_rows on the same inputs."""
    cfg, ds = _node_scene(cuda, "5_lights")
    light, node, _, kw = _shade_inputs(cfg, ds, cuda, 131072, 35)
    kw = _node_kw(cfg, kw)
    n = (1 << 20) + 37
    rays = [torch.cat([a] * -(-n // 131072))[:n].contiguous() for a in (*light[5:], *node)]
    pix = torch.arange(n, dtype=torch.int32, device=cuda)
    sparse = torch.from_numpy(np.random.default_rng(36).random(n) < 0.05).to(cuda)
    for thin in (False, True):
        if thin:
            rays[5] = rays[5] * sparse  # valid
        args = (*light[:5], *rays)
        rows = kernels.shade_eval_rows(*args, pix, **kw)
        for most in (1 << 30, -1):
            monkeypatch.setattr(kernels, "NODE_WARP_MAX_LIVE", most)
            assert_node_bits(rows, kernels.shade_eval(*args, **kw))
    assert rows[2].any() and rows[4].any()


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["5_lights", "50_lights", "cloud"])
def test_light_shade_kernel_widths_and_bits(cuda, scene):
    """Ray counts from 0 to a tile: the twin's values within its bar, and
    the same bits on three runs."""
    cfg, ds = _node_scene(cuda, scene)
    light, _, _, kw = _shade_inputs(cfg, ds, cuda, 131072, 35)
    for n in RESIDENT_WIDTHS:
        args = (*light[:5], *(a[:n].contiguous() for a in light[5:]))
        kernels.reset_launch_counts()
        got = kernels.light_shade(*args, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["light_shade"] == 1
        assert got[0].shape == got[1].shape == (n, 3)
        ref = kernels.light_shade_plain(*args, **kw)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6)
        for _ in range(2):
            assert all(same_bits(x, y) for x, y in zip(got, kernels.light_shade(*args, **kw)))
    assert (got[0].amax(dim=1) > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays", [2048, 131072], ids=["W", "R"])
def test_light_shade_at_95_lights_matches_twin(cuda, n_rays):
    """The packet path's lighting (reference_default's SIMD build: every
    node through light_shade, 95 lights in chunks of 16) at the pool's W =
    2048 and a tile's R: the twin's values within its bar, and the same
    bits on three runs."""
    cfg = RenderConfig.reference_default(packet_mode=True, aa_packet_lanes=8,
                                         weight_cutoff=1e-3)
    scene = Scene.backface_culling(build("semesterbild", cfg), np.array([0.0, 0.0, 1.0]))
    ds = build_device_scene(scene, cfg, device=cuda)
    assert ds.n_lights == 95
    light, _, _, kw = _shade_inputs(cfg, ds, cuda, n_rays, 95)
    kernels.reset_launch_counts()
    got = kernels.light_shade(*light, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["light_shade"] == 1
    ref = kernels.light_shade_plain(*light, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6)
    for _ in range(2):
        assert all(same_bits(x, y) for x, y in zip(got, kernels.light_shade(*light, **kw)))
    assert (got[0].amax(dim=1) > 0).any()


@pytest.mark.gpu
def test_packet_render_matches_cpu_twins(cuda):
    """The SIMD build's frame (packet_mode, 16 AA lanes a pixel) on the
    pool path, resident and streamed: the card against the CPU twins at
    the image bar."""
    kw = dict(width=40, height=30, scene_backface_culling=True, tile_rays=8192,
              kernel_ray_tile=64, compaction_ratio=8, loop_chunk=16, max_nodes=48,
              weight_cutoff=1e-3, device_encode=True, packet_mode=True, aa_packet_lanes=8,
              anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True, **REALISTIC)
    for extra, used in ((dict(), {"cast_triangles", "light_shade"}),
                        (dict(stream_triangles=1),
                         {"cast_triangles_stream", "occlude_triangles_stream"})):
        cfg = RenderConfig(**kw, **extra)
        scene = build("semesterbild", cfg)
        frames = {}
        for dev in (cuda, "cpu"):
            r = RaytracerRenderer(cfg, device=dev)
            kernels.reset_launch_counts()
            frames[str(dev)] = r.render_u32(r.device_scene(scene))
            assert r.last_dropped == 0
            if dev == cuda:
                assert {k for k, v in kernels.LAUNCHES.items() if v} == used
        gpu, cpu = frames[str(cuda)], frames["cpu"]
        assert ((gpu != 0) == (cpu != 0)).mean() > 0.995
        rgb = lambda f: np.stack([(f >> s) & 0xFF for s in (16, 8, 0)], -1) / 255.0  # noqa: E731
        assert (np.abs(rgb(gpu) - rgb(cpu)).max(-1) > 2e-3).mean() < 0.005


def _partition_scene(dev, name, width=1920, height=1080, edge_sigma=0.006, **features):
    """semesterbild plus a cloud of 2400 small triangles, a quarter of them
    glass, resident, at one of PARTITIONS."""
    cfg = RenderConfig(width=width, height=height, scene_backface_culling=True,
                       weight_cutoff=1e-3, **PARTITIONS[name], **(features or REALISTIC))
    scene = triangle_cloud.build_scene(cfg, n=2400, edge_sigma=edge_sigma, glass_share=0.25)
    ds = build_device_scene(Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0])), cfg,
                            device=dev)
    assert not ds.streaming and ds.tri_block == PARTITIONS[name]["triangle_block"]
    assert (max(ds.sb_sizes) > 32) == (name == "superblock64")
    return cfg, ds, scene


@pytest.mark.gpu
@pytest.mark.parametrize("partition", sorted(PARTITIONS))
def test_warp_kernels_take_any_partition(cuda, monkeypatch, partition):
    """The five kernels with a warp per ray, and shade_eval, on a superblock
    of more than 32 blocks and on blocks of 48 rows, in each form: both
    casts' t and index identical to their twins, both occlusions' `opq`
    identical (sums within 1e-5 where it is false), shade_eval_rows within
    its twin's bar and shade_eval bit for bit equal to it."""
    cfg, ds, _ = _partition_scene(cuda, partition)
    o, d = _hard_rays(cfg, ds, cuda, 4096 + 37, 41)
    md = _max_distances(o.shape[0], 42, cuda)
    tables = (ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    light, node, pix, kw = _shade_inputs(cfg, ds, cuda, 4096 + 37, 43)
    kw = _node_kw(cfg, kw)
    for least in (1 << 30, 0):  # one ray per warp; many
        monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", least)
        for bf in (False, True):
            t, idx = kernels.cast_triangles(ds.trb_pack, *tables, o, d, sb_sizes=ds.sb_sizes,
                                            backface_culling=bf)
            t_ref, idx_ref = kernels.cast_triangles_plain(ds.trb_pack, tables[0], o, d, bf)
            assert torch.equal(idx, idx_ref) and same_bits(t, t_ref)
            t, idx = kernels.cast_triangles_stream(*tables, o, d, sb_sizes=ds.sb_sizes,
                                                   backface_culling=bf)
            t_ref, idx_ref = kernels.cast_triangles_stream_plain(tables[0], o, d, bf)
            assert torch.equal(idx, idx_ref) and same_bits(t, t_ref)
            assert torch.isfinite(t).sum() > 100
            got = kernels.occlude_triangles_stream(
                *tables, o, d, md, sb_sizes=ds.sb_sizes, backface_culling=bf,
                block_has_trans=ds.block_has_trans)
            _assert_occlusion(got, kernels.occlude_triangles_stream_plain(tables[0], o, d, md, bf),
                              varied=False)
            assert got[1].any()
            got = kernels.occlude_triangles(
                ds.trb_pack, *tables, o, d, md, sb_sizes=ds.sb_sizes, backface_culling=bf,
                bigtri_trans=ds.bigtri_trans, block_has_trans=ds.block_has_trans)
            _assert_occlusion(got, kernels.occlude_triangles_plain(ds.trb_pack, tables[0], o, d,
                                                                   md, bf), varied=False)
            assert got[1].any()
        rows = kernels.shade_eval_rows(*light, *node, pix, **kw)
        ref = kernels.shade_eval_rows_plain(*light, *node, pix, **kw)
        assert torch.equal(rows[2], ref[2]) and torch.equal(rows[4], ref[4])
        for a, b, m in ((rows[0], ref[0], None), (rows[1], ref[1], rows[2]),
                        (rows[3], ref[3], rows[4])):
            a, b = (a, b) if m is None else (a[m], b[m])
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6)
        for most in (1 << 30, -1):
            monkeypatch.setattr(kernels, "NODE_WARP_MAX_LIVE", most)
            assert_node_bits(rows, kernels.shade_eval(*light, *node, **kw))
    assert rows[2].any() and rows[4].any()


@pytest.mark.gpu
@pytest.mark.parametrize("partition", sorted(PARTITIONS))
@pytest.mark.parametrize("path", ["pool", "stack", "default"])
def test_partition_render_matches_cpu_twins(cuda, partition, path):
    """Small frames of the cloud scene at each of PARTITIONS, on the card
    and through the CPU twins: the image bar (fewer than 0.5% of pixels off
    by more than 2e-3), `valid` apart only at knife edges."""
    features = {"pool": REALISTIC, "stack": dict(REALISTIC, compaction_ratio=1),
                "default": {}}[path]
    kw = dict(tile_rays=4096, kernel_ray_tile=128, compaction_ratio=8, loop_chunk=16,
              max_nodes=48, device_encode=True)
    cfg, _, scene = _partition_scene(cuda, partition, width=64, height=48, edge_sigma=0.05,
                                     **dict(kw, **features))
    frames = {}
    for dev in (cuda, "cpu"):
        r = RaytracerRenderer(cfg, device=dev)
        ds = r.device_scene(scene)
        assert (max(ds.sb_sizes) > 32) == (partition == "superblock64")
        frames[str(dev)] = r.render_u32(ds)
        assert r.last_dropped == 0
    gpu, cpu = frames[str(cuda)], frames["cpu"]
    assert ((gpu != 0) == (cpu != 0)).mean() > 0.995
    rgb = lambda f: np.stack([(f >> s) & 0xFF for s in (16, 8, 0)], -1) / 255.0  # noqa: E731
    off = np.abs(rgb(gpu) - rgb(cpu)).max(-1) > 2e-3
    assert off.mean() < 0.005


@pytest.mark.gpu
def test_resident_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """On the card: tables off a 16-byte boundary, big-primitive packs of
    more than 128 rows (the cast, the node kernels and the resident
    occlusion). The CPU route takes them."""
    cfg, ds = _scene(cuda)
    o, d = _hard_rays(cfg, ds, cuda, 256, 11)
    light, node, pix, kw = _shade_inputs(cfg, ds, cuda, 256, 3)
    kw = _node_kw(cfg, kw)
    cast = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    shifted = torch.empty(ds.tri_aabb.numel() + 1, device=cuda)[1:].view_as(ds.tri_aabb)
    shifted.copy_(ds.tri_aabb)
    wide = torch.cat([ds.trb_pack] * 3)  # 144 rows
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.cast_triangles(cast[0], cast[1], shifted, cast[3], o, d, sb_sizes=ds.sb_sizes)
    with pytest.raises(ValueError, match="at most 128"):
        kernels.cast_triangles(wide, *cast[1:], o, d, sb_sizes=ds.sb_sizes)
    for node_kernel, extra in ((kernels.shade_eval_rows, (pix,)), (kernels.shade_eval, ())):
        with pytest.raises(ValueError, match="16 bytes"):
            node_kernel(*light[:4], shifted, *light[5:], *node, *extra, **kw)
        with pytest.raises(ValueError, match="at most 128"):
            node_kernel(*light[:2], wide, *light[3:], *node, *extra, **kw)
    md = _max_distances(256, 13, cuda)
    okw = dict(sb_sizes=ds.sb_sizes, bigtri_trans=ds.bigtri_trans)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.occlude_triangles(cast[0], cast[1], shifted, cast[3], o, d, md, **okw)
    with pytest.raises(ValueError, match="at most 128"):
        kernels.occlude_triangles(wide, *cast[1:], o, d, md, **okw)
    assert sum(kernels.LAUNCHES.values()) == 0  # a refusal launches nothing
    dec, _, _ = kernels.occlude_triangles(*(x.cpu() for x in (wide, *cast[1:], o, d, md)),
                                          **okw)
    assert dec.shape == (256,)
    t, _ = kernels.cast_triangles(wide.cpu(), ds.tri_cast_pack.cpu(), ds.tri_aabb.cpu(),
                                  ds.tri_saabb.cpu(), o.cpu(), d.cpu(), sb_sizes=ds.sb_sizes)
    assert t.shape == (256,)


def _cloud_scene(dev, n=20000):
    """semesterbild plus a cloud of n small triangles, a quarter of it glass,
    at the 1080p block size: big primitives, superblocks, and Morton blocks
    with and without transmissive triangles."""
    cfg = RenderConfig(width=1920, height=1080, scene_backface_culling=True, **REALISTIC)
    scene = triangle_cloud.build_scene(cfg, n=n, edge_sigma=0.006, glass_share=0.25)
    ds = build_device_scene(Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0])), cfg,
                            device=dev)
    assert len(set(ds.block_has_trans)) == 2 and max(ds.sb_sizes) > 1
    return cfg, ds


def _hard_rays(cfg, ds, dev, n, seed):
    """Random rays plus the cases a gate can get wrong: rays that start on a
    face of a block's box and run along it (0 * inf in the slab test), NaN
    rays, and parked lanes (origin 1e9)."""
    o, d = _rays(cfg, n, seed)
    box = ds.tri_aabb.cpu().numpy()
    k = min(64, box.shape[0])
    o[:k] = box[:k, 0:3]  # the box's min corner: on three faces at once
    d[:k] = np.eye(3, dtype=np.float32)[np.arange(k) % 3]  # along an edge
    o[k:2 * k] = 0.5 * (box[:k, 0:3] + box[:k, 3:6])
    o[k:2 * k, 1] = box[:k, 4]  # on the max-y face, heading inward-diagonally
    d[k:2 * k] = np.float32([0.6, 0.0, 0.8])
    o[2 * k:2 * k + 8] = np.nan
    d[2 * k + 8:2 * k + 16] = np.nan
    o[2 * k + 16:2 * k + 32] = 1e9
    d[2 * k + 16:2 * k + 32] = np.float32([0.0, 0.0, 1.0])
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _max_distances(n, seed, dev):
    rng = np.random.default_rng(seed)
    md = rng.uniform(0.02, 1.5, n).astype(np.float32)
    md[3::13] = 0.0
    md[7::29] = -1.0
    md[11::53] = np.inf
    md[17::101] = np.nan
    return torch.from_numpy(md).to(dev)


def _stream_tables(dev, case):
    """(cfg, scene, (tri_cast_pack, tri_aabb, tri_saabb), sb_sizes, the slots
    of the coincident triangles) of one case of the streamed kernels' tests:
    cloud    the scene of `_cloud_scene`: superblocks of 8 blocks;
    singletons
             the same with every block a superblock of its own (the
             partition that trailing empty blocks get);
    empty    built with `min_tri_blocks=7`: trailing empty blocks, each with
             an inverted box in a superblock of its own;
    ties     the cloud with its most-hit triangle copied into an earlier and
             a later slot of its block and into two other blocks, the boxes
             grown to hold it: coincident triangles, where the earlier block
             and the lower slot must win."""
    if case == "empty":
        cfg = RenderConfig(width=1920, height=1080, scene_backface_culling=True, **REALISTIC)
        scene = triangle_cloud.build_scene(cfg, n=20000, edge_sigma=0.006, glass_share=0.25)
        ds = build_device_scene(Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0])), cfg,
                                min_tri_blocks=7, device=dev)
        empty = (ds.tri_aabb[:, 0] > ds.tri_aabb[:, 3]).cpu().numpy()
        assert empty.any() and not ds.tri_cast_pack[torch.from_numpy(empty).to(dev)][..., 13].any()
        assert all(n == 1 for n in ds.sb_sizes[-int(empty.sum()):])
    else:
        cfg, ds = _cloud_scene(dev)
    pack, aabb, saabb, sizes = ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb, ds.sb_sizes
    same = []
    if case == "singletons":
        saabb, sizes = aabb, (1,) * aabb.shape[0]
    if case == "ties":
        o, d = (torch.from_numpy(a).to(dev) for a in _rays(cfg, 8192 + 37, 11))
        _, idx = kernels.cast_triangles_stream_plain(pack, o[256:1024], d[256:1024], False)
        B = pack.shape[1]
        slots, counts = torch.unique(idx[idx < pack.shape[0] * B], return_counts=True)
        src = int(slots[counts.argmax()])
        b, c = divmod(src, B)
        assert 2 <= b < pack.shape[0] - 2
        pack, aabb, saabb = pack.clone(), aabb.clone(), saabb.clone()
        starts = np.concatenate([[0], np.cumsum(sizes)])
        same = [src]
        for b2, c2 in ((b, (c + 5) % B), (b, (c - 7) % B), (b - 2, 9), (b + 2, 40)):
            pack[b2, c2] = pack[b, c]
            same.append(b2 * B + c2)
            g = int(np.searchsorted(starts, b2, side="right") - 1)
            for box in (aabb[b2], saabb[g]):
                box[0:3] = torch.minimum(box[0:3], aabb[b, 0:3])
                box[3:6] = torch.maximum(box[3:6], aabb[b, 3:6])
    return cfg, ds, (pack.contiguous(), aabb, saabb), sizes, sorted(same)


STREAM_CASES = ["cloud", "singletons", "empty", "ties"]
STREAM_WIDTHS = (0, 1, 7, 2049)  # ragged warps and thread blocks; then all rays


@pytest.mark.gpu
@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("backface", [False, True])
def test_cast_stream_kernel_matches_twin(cuda, monkeypatch, backface, case):
    cfg, ds, tables, sizes, same = _stream_tables(cuda, case)
    o_all, d_all = _hard_rays(cfg, ds, cuda, 8192 + 37, 11)
    for n in STREAM_WIDTHS + (o_all.shape[0],):
        o, d = o_all[:n].contiguous(), d_all[:n].contiguous()
        kernels.reset_launch_counts()
        t, idx = kernels.cast_triangles_stream(*tables, o, d, backface_culling=backface,
                                               sb_sizes=sizes)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["cast_triangles_stream"] == 1
        t_ref, idx_ref = kernels.cast_triangles_stream_plain(tables[0], o, d, backface)
        # identical index and t: the same operations in the same order, the
        # widened gate never culls a block that holds a nearer hit, and on equal
        # t the earlier block and the lower slot win
        assert t.shape == (n,) and idx.dtype == torch.int32
        assert torch.equal(idx, idx_ref) and torch.equal(t, t_ref)
        for _ in range(2):  # the same bits on every run
            again = kernels.cast_triangles_stream(*tables, o, d, backface_culling=backface,
                                                  sb_sizes=sizes)
            assert torch.equal(again[0], t) and torch.equal(again[1], idx)
    assert torch.isfinite(t).sum() > 100 and (~torch.isfinite(t)).any()
    # eight rays per warp (the form that many rays take): the same answer, at
    # ray counts that leave the last warp and the last thread block ragged
    assert kernels.rays_per_warp(o_all.shape[0]) == 1
    monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 1)
    for n in (1, 7, 2049, o_all.shape[0]):
        t8, idx8 = kernels.cast_triangles_stream(
            *tables, o_all[:n].contiguous(), d_all[:n].contiguous(),
            backface_culling=backface, sb_sizes=sizes)
        assert torch.equal(t8, t[:n]) and torch.equal(idx8, idx[:n])
    if case == "ties":
        # of five coincident triangles only the first in storage order is hit
        assert (idx == same[0]).any()
        assert not torch.isin(idx, torch.tensor(same[1:], device=cuda, dtype=idx.dtype)).any()
    if case == "cloud":
        # the scene-level cast adds spheres and big primitives
        hit = cast_rays(dataclasses.replace(ds, streaming=True), o_all, d_all, backface)
        ref = cast_rays(ds, o_all, d_all, backface)
        assert torch.equal(hit.valid, ref.valid) and torch.equal(hit.t, ref.t)
        assert torch.equal(hit.obj_idx[hit.valid], ref.obj_idx[ref.valid])


@pytest.mark.gpu
def test_stream_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """On the card: tables off a 16-byte boundary. The CPU route takes
    them."""
    cfg, ds, (pack, aabb, saabb), sizes, _ = _stream_tables(cuda, "cloud")
    o, d = _hard_rays(cfg, ds, cuda, 256, 11)
    md = _max_distances(256, 13, cuda)
    shifted = torch.empty(aabb.numel() + 1, device=cuda)[1:].view_as(aabb).copy_(aabb)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.cast_triangles_stream(pack, shifted, saabb, o, d, sb_sizes=sizes)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.occlude_triangles_stream(pack, shifted, saabb, o, d, md, sb_sizes=sizes)
    assert sum(kernels.LAUNCHES.values()) == 0  # a refusal launches nothing
    t, _ = kernels.cast_triangles_stream(pack.cpu(), shifted.cpu(), saabb.cpu(), o.cpu(),
                                         d.cpu(), sb_sizes=sizes)
    assert t.shape == (256,)


def _assert_occlusion(got, ref, varied=True):
    """`opq` identical, the sums within 1e-5 where it is false; `varied`: the
    rays are many enough to hold occluded, free and partly shaded ones."""
    dec, opq, fsub = got
    dec_ref, opq_ref, fsub_ref = ref
    assert torch.equal(opq, opq_ref)
    free = ~opq_ref
    np.testing.assert_allclose(dec[free].cpu().numpy(), dec_ref[free].cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(fsub[free].cpu().numpy(), fsub_ref[free].cpu().numpy(), atol=1e-5)
    if not varied:
        return
    assert opq.any() and free.any() and (dec[free] > 0).any()
    part = dec[free]
    assert ((part > 0) & (part != part.round())).any()  # transmissive hits


@pytest.mark.gpu
@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("backface", [False, True])
def test_occlude_stream_kernel_matches_twin(cuda, monkeypatch, backface, case):
    cfg, ds, tables, sizes, same = _stream_tables(cuda, case)
    o_all, d_all = _hard_rays(cfg, ds, cuda, 8192 + 37, 12)
    md_all = _max_distances(o_all.shape[0], 13, cuda)
    # the per-block transmissive flags, from the rows (a copied glass
    # triangle makes its new block transmissive)
    has_trans = tuple((tables[0][:, :, 14] != 0).any(dim=1).tolist())
    assert has_trans == ds.block_has_trans or case == "ties"
    kw = dict(backface_culling=backface, block_has_trans=has_trans, sb_sizes=sizes)
    for n in STREAM_WIDTHS + (o_all.shape[0],):
        args = (*tables, o_all[:n].contiguous(), d_all[:n].contiguous(), md_all[:n].contiguous())
        kernels.reset_launch_counts()
        got = kernels.occlude_triangles_stream(*args, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["occlude_triangles_stream"] == 1
        ref = kernels.occlude_triangles_stream_plain(tables[0], *args[3:], backface)
        assert got[0].shape == (n,) and got[1].dtype == torch.bool and got[2].shape == (n, 3)
        _assert_occlusion(got, ref, varied=n > 2049)
        dead = ~(args[5] > 0)  # max_distance <= 0 or NaN: zeros
        assert not got[1][dead].any() and not got[0][dead].any() and not got[2][dead].any()
        # the same bits on every run: no atomics, sums in slot order
        for _ in range(2):
            again = kernels.occlude_triangles_stream(*args, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
    # an empty flag tuple runs the shadow Fresnel on every block: same sums
    every = kernels.occlude_triangles_stream(*args, backface_culling=backface, sb_sizes=sizes)
    assert all(torch.equal(a, b) for a, b in zip(got, every))
    # eight rays per warp (the form that many rays take): `opq` and, where it
    # is false, the bits of the sums are those of one ray per warp
    assert kernels.rays_per_warp(o_all.shape[0]) == 1
    monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 1)
    for n in (1, 7, 2049, o_all.shape[0]):
        dec8, opq8, fsub8 = kernels.occlude_triangles_stream(
            *tables, *(a[:n].contiguous() for a in args[3:]), **kw)
        free = ~opq8
        assert torch.equal(opq8, got[1][:n])
        assert torch.equal(dec8[free], got[0][:n][free])
        assert torch.equal(fsub8[free], got[2][:n][free])


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["one", "many"])
@pytest.mark.parametrize("scene", ["semesterbild", "cloud"])
@pytest.mark.parametrize("backface", [False, True])
def test_occlude_kernel_matches_twin(cuda, monkeypatch, scene, backface, form):
    """The resident occlusion in each form (one ray per warp; many, from
    PACKET_MIN_RAYS on) against its twin, at ray counts that leave the last
    warp and the last thread block ragged; the same bits on every run and
    in the other form."""
    cfg, ds = _scene(cuda) if scene == "semesterbild" else _cloud_scene(cuda)
    o_all, d_all = _hard_rays(cfg, ds, cuda, 8192 + 37, 14)
    md_all = _max_distances(o_all.shape[0], 15, cuda)
    kw = dict(backface_culling=backface, bigtri_trans=ds.bigtri_trans,
              block_has_trans=ds.block_has_trans, sb_sizes=ds.sb_sizes)
    tables = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 1 << 30 if form == "one" else 0)
    for n in STREAM_WIDTHS + (o_all.shape[0],):
        o, d, md = (a[:n].contiguous() for a in (o_all, d_all, md_all))
        kernels.reset_launch_counts()
        got = kernels.occlude_triangles(*tables, o, d, md, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["occlude_triangles"] == 1
        assert got[0].shape == (n,) and got[1].dtype == torch.bool and got[2].shape == (n, 3)
        _assert_occlusion(got, kernels.occlude_triangles_plain(ds.trb_pack, ds.tri_cast_pack, o,
                                                               d, md, backface),
                          varied=n > 2049)
        dead = ~(md > 0)  # max_distance <= 0 or NaN: zeros
        assert not got[1][dead].any() and not got[0][dead].any() and not got[2][dead].any()
        for _ in range(2):
            again = kernels.occlude_triangles(*tables, o, d, md, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        _other_form(monkeypatch, n)
        assert same_occlusion(got, kernels.occlude_triangles(*tables, o, d, md, **kw))
        monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 1 << 30 if form == "one" else 0)
    # a superblock per block (an empty partition) gives the same bits
    every = kernels.occlude_triangles(*tables[:3], ds.tri_aabb, o, d, md,
                                      **dict(kw, sb_sizes=()))
    assert same_occlusion(got, every)


@pytest.mark.gpu
@pytest.mark.parametrize("streaming", [False, True], ids=["resident", "streamed"])
def test_occlude_rays_card_matches_cpu(cuda, streaming):
    """The scene-level entry point on the card (kernels) against the CPU
    (twins) on the same rays."""
    cfg, ds = _cloud_scene(cuda, n=4000)
    ds = dataclasses.replace(ds, streaming=streaming)
    cpu = dataclasses.replace(ds, **{
        f.name: getattr(ds, f.name).cpu() for f in dataclasses.fields(ds)
        if isinstance(getattr(ds, f.name), torch.Tensor)})
    o, d = _hard_rays(cfg, ds, cuda, 2048, 16)
    md = _max_distances(o.shape[0], 17, cuda)
    kernels.reset_launch_counts()
    got = occlude_rays(ds, o, d, md, True)
    name = "occlude_triangles_stream" if streaming else "occlude_triangles"
    assert {k for k, v in kernels.LAUNCHES.items() if v} == {name}
    ref = occlude_rays(cpu, o.cpu(), d.cpu(), md.cpu(), True)
    assert sum(kernels.LAUNCHES.values()) == 1
    opq = ref[0].numpy()
    np.testing.assert_array_equal(got[0].cpu().numpy(), opq)
    np.testing.assert_allclose(got[1].cpu().numpy()[~opq], ref[1].numpy()[~opq], atol=1e-5)
    np.testing.assert_allclose(got[2].cpu().numpy()[~opq], ref[2].numpy()[~opq], atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["pool", "stack", "unpacked", "default", "soft_shadows",
                                  "streamed", "streamed_stack"])
def test_small_render_matches_cpu_twins(cuda, path):
    features = {
        "streamed": dict(REALISTIC, stream_triangles=1),
        "streamed_stack": dict(REALISTIC, compaction_ratio=1, stream_triangles=1),
        "pool": REALISTIC,
        "stack": dict(REALISTIC, compaction_ratio=1),
        "unpacked": dict(REALISTIC, packed_stage=False),
        "default": dict(),
        "soft_shadows": dict(soft_shadows=True),
    }[path]
    kw = dict(width=64, height=48, scene_backface_culling=True, tile_rays=4096,
              kernel_ray_tile=128, compaction_ratio=8, loop_chunk=16,
              max_nodes=48, weight_cutoff=1e-3, device_encode=True)
    cfg = RenderConfig(**dict(kw, **features))
    scene = build("semesterbild", cfg)
    frames = {}
    for dev in (cuda, "cpu"):
        r = RaytracerRenderer(cfg, device=dev)
        frames[str(dev)] = r.render_u32(r.device_scene(scene))
        assert r.last_dropped == 0
    gpu, cpu = frames[str(cuda)], frames["cpu"]
    assert ((gpu != 0) == (cpu != 0)).mean() > 0.995
    rgb = lambda f: np.stack([(f >> s) & 0xFF for s in (16, 8, 0)], -1) / 255.0  # noqa: E731
    off = np.abs(rgb(gpu) - rgb(cpu)).max(-1) > 2e-3
    assert off.mean() < 0.005


def _kernel_calls(dev):
    """The first call of every kernel wrapper, (args, kw), caught from small
    renders of the paths that launch them and from `occlude_rays`."""
    base = dict(width=64, height=32, kernel_ray_tile=64, compaction_ratio=8, loop_chunk=8,
                max_nodes=16, device_encode=True)
    runs = {
        ("cast_triangles", "shade_eval_rows"): dict(base, **REALISTIC),
        ("shade_eval",): dict(base, **dict(REALISTIC, compaction_ratio=1)),
        ("light_shade",): base,
        ("cast_triangles_stream", "occlude_triangles_stream"): dict(
            base, stream_triangles=1, **REALISTIC),
    }
    calls = {}
    for names, kw in runs.items():
        cfg = RenderConfig(**kw)
        r = RaytracerRenderer(cfg, device=dev)
        ds = r.device_scene(build("semesterbild", cfg))
        for name, caught in caught_calls(names, lambda: r.render_u32(ds), 1).items():
            calls[name] = caught[0]
    cfg, ds = _scene(dev)
    o, d = (torch.from_numpy(a).to(dev) for a in _rays(cfg, 4096, 5))
    md = torch.full((4096,), 4.0, device=dev)
    calls["occlude_triangles"] = caught_calls(
        ["occlude_triangles"], lambda: occlude_rays(ds, o, d, md), 1)["occlude_triangles"][0]
    return calls


@pytest.mark.gpu
def test_kernels_from_two_threads_give_one_thread_bits(cuda):
    """Each kernel launched from two host threads at once, each under a
    stream of its own (as two mesh entries on one card launch them): the
    bits of a launch from this thread, and every launch counted."""
    from concurrent.futures import ThreadPoolExecutor

    calls = _kernel_calls(cuda)
    assert set(calls) == set(kernels.KERNEL_SOURCES)
    for name, (args, kw) in calls.items():
        wrapper = getattr(kernels, name)
        ref = flat(wrapper(*args, **kw))
        torch.cuda.synchronize()

        def launch(_):
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                out = flat(wrapper(*args, **kw))
            stream.synchronize()
            return out

        kernels.reset_launch_counts()
        with ThreadPoolExecutor(max_workers=2) as pool:
            outs = [f.result(timeout=300) for f in [pool.submit(launch, i) for i in range(2)]]
        assert kernels.LAUNCHES == {**{k: 2 * (k == name) for k in kernels.KERNEL_SOURCES},
                                    kernels.LIGHT_LANES_LAUNCHES: 0}, name
        for out in outs:
            assert len(out) == len(ref) and all(same_bits(a, b) for a, b in zip(out, ref)), name


@pytest.mark.gpu
def test_mesh_on_one_card_has_one_device_bits(cuda):
    """RaytracerRenderer(devices=2) on the card listed twice, and the objs
    axis cast on four entries: the one-device frame and the dense cast."""
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import parallel

    cfg = RenderConfig(width=128, height=64, tile_rays=2048, kernel_ray_tile=64,
                       compaction_ratio=8, loop_chunk=8, max_nodes=16, device_encode=True,
                       **REALISTIC)
    r1 = RaytracerRenderer(cfg, device=cuda)
    ds = r1.device_scene(build("semesterbild", cfg))
    r2 = RaytracerRenderer(dataclasses.replace(cfg, devices=2), device=["cuda:0"] * 2)
    assert np.array_equal(r2.render_u32(ds), r1.render_u32(ds))
    assert r2.last_dropped == r1.last_dropped == 0

    scene = build_device_scene(build("semesterbild", cfg), cfg, min_tri_blocks=4, device=cuda)
    o, d = (torch.from_numpy(a).to(cuda) for a in _rays(cfg, 4096, 6))
    kernels.reset_launch_counts()
    t, idx, valid = parallel.cast_nearest_objsharded(
        scene, o, d, parallel.make_mesh(devices=["cuda:0"] * 4, axis="objs"))
    assert kernels.LAUNCHES["cast_triangles_stream"] == 4
    hit = cast_rays(scene, o, d)
    assert torch.equal(valid, hit.valid) and torch.equal(idx[valid], hit.obj_idx[valid])
    np.testing.assert_allclose(t[valid].cpu().numpy(), hit.t[valid].cpu().numpy(), rtol=1e-6)


# ---- the shadow scan where it crosses many opaque Morton blocks -----------


def _forms_match_twins(monkeypatch, light, node, pix, kw, label):
    """The three shading kernels in every form against their twins:
    light_shade and shade_eval_rows in its three forms within the twins'
    bar (shade_eval_rows' masks identical), shade_eval with a warp per live
    ray and a ray per lane bit for bit shade_eval_rows'."""
    lkw = {k: kw[k] for k in ("n_lights", "eps_dist", "n_trans_blocks", "bigtri_trans_rows")}
    got, ref = kernels.light_shade(*light, **lkw), kernels.light_shade_plain(*light, **lkw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6,
                                   err_msg=f"light_shade {label}")
    ref = kernels.shade_eval_rows_plain(*light, *node, pix, **kw)
    for form in NODE_FORMS:
        with monkeypatch.context() as mp:
            _other_form(mp, light[5].shape[0], form)
            rows = kernels.shade_eval_rows(*light, *node, pix, **kw)
        assert torch.equal(rows[2], ref[2]) and torch.equal(rows[4], ref[4]), (label, form)
        for a, b, m in ((rows[0], ref[0], None), (rows[1], ref[1], rows[2]),
                        (rows[3], ref[3], rows[4])):
            a, b = (a, b) if m is None else (a[m], b[m])
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=2e-6,
                                       err_msg=f"shade_eval_rows {label} form {form}")
    for most in (1 << 30, -1):
        monkeypatch.setattr(kernels, "NODE_WARP_MAX_LIVE", most)
        assert_node_bits(rows, kernels.shade_eval(*light, *node, **kw))
    return got[0]


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [5, 50, 95])
def test_shading_forms_match_twins_on_the_cloud(cuda, monkeypatch, n_lights):
    """On the 235-block cloud (65 blocks with glass, 170 opaque) at 5, 50
    and 95 lights: the storage-order walk and its first-opaque-hit exit over
    many opaque blocks."""
    cfg, ds = cloud_scene(n_lights, cuda)
    assert 0 < ds.n_trans_blocks < ds.tri_blk_pack.shape[0] == 235
    light, node, pix, kw = _shade_inputs(cfg, ds, cuda, 4099, 41)
    _forms_match_twins(monkeypatch, light, node, pix, _node_kw(cfg, kw), f"{n_lights} lights")


@pytest.mark.gpu
def test_shading_forms_match_twins_on_the_stack_scene(cuda, monkeypatch):
    """On the two-cluster stack scene (17 lights, four opaque blocks on one
    shadow column): the grid's umbra is dark and the open lanes lit."""
    cfg, ds, light = stack_inputs(device=cuda)
    n = light[5].shape[0]
    kw = dict(n_lights=ds.n_lights, eps_dist=float(cfg.camera.epsilon_distance),
              n_trans_blocks=ds.n_trans_blocks, bigtri_trans_rows=ds.bigtri_trans_rows,
              refl_max=5, refr_max=10, weight_cutoff=1e-3, air=AIR)
    direct = _forms_match_twins(monkeypatch, light, node_state(n, 43, cuda),
                                torch.arange(n, dtype=torch.int32, device=cuda), kw,
                                "stack scene")
    x = light[5][:, 0]
    umbra, lit = direct[(x > 0.22) & (x < 0.28)], direct[(x > 0.6) & (x < 0.9)]
    assert float(umbra.mean()) < 0.5 * float(lit.mean()) and float(lit.mean()) > 0.0
