"""PyTorch port on the card: each CUDA kernel against its plain twin, the
pool's chunk commit, and small renders against the CPU twins.

Needs an NVIDIA GPU and nvcc; every test carries the `gpu` marker and skips
from the `cuda` fixture when there is no card. This file imports neither JAX
nor the JAX test helpers, so on the card (where JAX is not installed) it
runs without the repository's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

from __future__ import annotations

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
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import cast_rays
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.trace import AIR, _commit
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene

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


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["pool", "stack", "unpacked", "default", "soft_shadows"])
def test_small_render_matches_cpu_twins(cuda, path):
    features = {
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
