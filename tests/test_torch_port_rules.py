"""PyTorch port: the rules the package keeps.

* it imports neither JAX nor anything of the JAX package;
* entry points run on the card unless the caller passes device="cpu", and
  raise (never fall back quietly) when there is no card;
* the kernel wrappers take the plain twin only for CPU tensors, count
  launches only for kernel launches, and check their inputs;
* the card-only tests carry the registered `gpu` marker and decide inside a
  fixture whether to skip.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

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
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.trace import trace_rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import hslu_i.ba_raytracing.f2501_raytracer_tpu_torch as p\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import renderer\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import semesterbild\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'hslu_i.ba_raytracing.f2501_raytracer_tpu'\n"
        "       or m.startswith('hslu_i.ba_raytracing.f2501_raytracer_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _small_cfg(**kw):
    return RenderConfig(
        width=16, height=8, reflections=True, refractions=True, device_encode=True,
        kernel_ray_tile=64, compaction_ratio=2, loop_chunk=4, max_nodes=4, **kw,
    )


def test_entry_points_default_to_the_card():
    cfg = _small_cfg()
    scene = build("semesterbild", cfg)
    if torch.cuda.is_available():
        assert RaytracerRenderer(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RaytracerRenderer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_device_scene(scene, cfg)
    # asked for, the CPU works
    r = RaytracerRenderer(cfg, device="cpu")
    fb = r.render_u32(r.device_scene(scene))
    assert fb.shape == (16 * 8,) and r.last_dropped == 0


def test_unported_paths_raise():
    cfg = _small_cfg()
    ds = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    o = torch.zeros((128, 3))
    d = torch.zeros((128, 3))
    d[:, 2] = 1.0
    unported = [
        _small_cfg(packet_mode=True, anti_aliasing=True),
        _small_cfg(stage_mode="gather"),
        _small_cfg(commit_splits=2),
        _small_cfg(resort_secondary=True),
    ]
    for bad in unported:
        with pytest.raises(NotImplementedError):
            trace_rays(ds, bad, o, d)
    # the f32 (device_encode=False) frame path
    with pytest.raises(NotImplementedError):
        RaytracerRenderer(RenderConfig(width=16, height=8), device="cpu")


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    cfg = _small_cfg()
    ds = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(0, 1, (64, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)), dim=1)
    kernels.reset_launch_counts()
    t, idx = kernels.cast_triangles(ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb,
                                    ds.tri_saabb, o, d, sb_sizes=ds.sb_sizes)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32 and t.shape == (64,)
    assert kernels.LAUNCHES == {"cast_triangles": 0, "shade_eval_rows": 0,
                                "shade_eval": 0, "light_shade": 0}
    with pytest.raises(TypeError):
        kernels.cast_triangles(ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb,
                               ds.tri_saabb, o.double(), d, sb_sizes=ds.sb_sizes)
    with pytest.raises(ValueError):
        kernels.cast_triangles(ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb,
                               ds.tri_saabb, o[:, :2], d, sb_sizes=ds.sb_sizes)
    with pytest.raises(ValueError):
        kernels.cast_triangles(ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb,
                               o.t().contiguous().t(), d, sb_sizes=ds.sb_sizes)
    # the shading wrappers: lighting inputs and node state
    tables = (ds.light_pack, ds.sph_pack, ds.trb_pack, ds.tri_blk_pack, ds.tri_blk_aabb)
    R = o.shape[0]
    light = (o, d, d, o, torch.zeros(R), torch.ones(R))
    kw = dict(n_lights=ds.n_lights, eps_dist=1e-4, n_trans_blocks=ds.n_trans_blocks,
              bigtri_trans_rows=ds.bigtri_trans_rows)
    direct, spec = kernels.light_shade(*tables, *light, **kw)
    assert direct.shape == spec.shape == (R, 3)
    with pytest.raises(TypeError):
        kernels.light_shade(*tables, o.double(), *light[1:], **kw)
    with pytest.raises(ValueError):
        kernels.light_shade(*tables, *light, **dict(kw, n_lights=ds.light_pack.shape[0] + 1))
    node = (torch.ones(R), torch.ones((R, 3)), torch.ones(R), torch.full((R,), -1, dtype=torch.int32),
            *[torch.zeros(R)] * 6)
    contrib, refl, refr = kernels.shade_eval(*tables, *light, *node, **kw)
    assert contrib.shape == (R, 3) and refl["budget"].dtype == refr["budget"].dtype == torch.int32
    with pytest.raises(TypeError):
        kernels.shade_eval(*tables, *light, *node[:3], node[3].long(), *node[4:], **kw)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_kernel_build_is_keyed_by_sources(tmp_path, monkeypatch):
    """Each kernel builds from the package's csrc/ into the ignored build
    directory, under a name that changes with its source, header or flags."""
    assert sorted(kernels.KERNEL_SOURCES) == [
        "cast_triangles", "light_shade", "shade_eval", "shade_eval_rows"]
    assert set(kernels.COMMON_HEADERS) == {"rt_common.cuh", "rt_light.cuh", "rt_node.cuh"}
    for f in kernels.COMMON_HEADERS:
        assert os.path.exists(os.path.join(kernels.CSRC, f))
    paths = {}
    for name, src in kernels.KERNEL_SOURCES.items():
        assert os.path.exists(os.path.join(kernels.CSRC, src))
        path = kernels._so_path(name)
        assert path.startswith(os.path.join(ROOT, "build", "torch_kernels"))
        assert path == kernels._so_path(name)
        paths[name] = path
    assert len(set(paths.values())) == len(paths)
    # an edit to a shared header renames every library
    shutil.copytree(kernels.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path / "csrc"))
    assert {n: kernels._so_path(n) for n in paths} == paths
    with open(tmp_path / "csrc" / "rt_light.cuh", "a") as fh:
        fh.write("// edited\n")
    assert all(kernels._so_path(n) != p for n, p in paths.items())
    assert "--fmad=false" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert not any("fast_math" in f for f in kernels.NVCC_FLAGS)
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert "build/torch_kernels/" in fh.read().split()


def test_gpu_tests_are_marked():
    import test_torch_kernels_gpu as g

    tests = [v for k, v in vars(g).items() if k.startswith("test_")]
    assert tests
    for fn in tests:
        marks = {m.name for m in getattr(fn, "pytestmark", [])}
        assert "gpu" in marks, fn.__name__
    with open(os.path.join(ROOT, "pytest.ini")) as fh:
        assert "    gpu:" in fh.read()
