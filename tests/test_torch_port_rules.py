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
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import hslu_i.ba_raytracing.f2501_raytracer_tpu_torch as p\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import renderer\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import semesterbild\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import __main__, output\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output import http_preview\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import test_scene\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import graft_entry, parallel\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.parallel import mesh\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.examples import (\n"
        "    semesterbild, test_scene, test_text)\n"
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
    """Nothing of the JAX package's configs is refused any more: every
    single-device knob traces (packet mode, the Morton resort, the gather
    and unique stage modes, commit splits), a mesh of devices renders
    (`devices=2` on two CPU entries), and packet mode without AA is refused
    as the JAX renderer refuses it."""
    cfg = _small_cfg()
    ds = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    o = torch.zeros((128, 3))
    d = torch.zeros((128, 3))
    d[:, 2] = 1.0
    ported = [
        _small_cfg(packet_mode=True, anti_aliasing=True),
        _small_cfg(stage_mode="gather"),
        _small_cfg(stage_mode="unique"),
        _small_cfg(commit_splits=2),
        _small_cfg(resort_secondary=True),
    ]
    for knob in ported:
        color, valid = trace_rays(ds, knob, o, d)
        assert color.shape == (128, 3) and valid.shape == (128,)
    r = RaytracerRenderer(_small_cfg(packet_mode=True, anti_aliasing=True), device="cpu")
    assert r.render_u32(ds).shape == (16 * 8,) and r.last_dropped == 0
    with pytest.raises(ValueError, match="anti_aliasing"):
        RaytracerRenderer(_small_cfg(packet_mode=True), device="cpu")
    r = RaytracerRenderer(_small_cfg(devices=2), device="cpu")
    assert len(r.mesh) == 2 and r.render_u32(ds).shape == (16 * 8,) and r.last_dropped == 0
    # the f32 (device_encode=False) frame path renders
    cfg = RenderConfig(width=16, height=8)
    assert not cfg.device_encode
    buf = RaytracerRenderer(cfg, device="cpu").render(build("semesterbild", cfg))
    assert buf.color.shape == (8, 16, 3) and buf.valid.mean() > 0.5


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
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNEL_SOURCES}
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


def test_cast_wrapper_needs_superblocks_and_takes_rays_as_given():
    """`cast_triangles` has no one-level mode: `sb_sizes` is required and
    must partition the blocks. Rays are (R, 3) rows as given: (3, R) or a
    transposed view is refused, on the CPU route as on the card's."""
    cfg = _small_cfg()
    ds = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    tables = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    o = torch.zeros((16, 3))
    d = torch.nn.functional.normalize(torch.ones((16, 3)), dim=1)
    with pytest.raises(TypeError, match="sb_sizes"):
        kernels.cast_triangles(*tables, o, d)
    with pytest.raises(ValueError, match="do not cover"):
        kernels.cast_triangles(*tables, o, d, sb_sizes=(ds.triangle_blocks + 1,))
    for bad in (o.t().contiguous(), o.t().contiguous().t()):
        with pytest.raises(ValueError):
            kernels.cast_triangles(*tables, bad, d, sb_sizes=ds.sb_sizes)
    t, idx = kernels.cast_triangles(*tables, o, d, sb_sizes=ds.sb_sizes)
    assert t.shape == idx.shape == (16,)


def test_resident_occlusion_wrapper_takes_the_warp_tables_and_rays_as_given():
    """`occlude_triangles` takes the block tables as the warp kernels do:
    `sb_sizes` must partition the blocks, with one superbox per entry, and
    an empty partition is a superblock per block (superboxes: the blocks'
    own boxes). Rays are (R, 3) rows as given: (3, R) or a transposed view
    is refused, on the CPU route as on the card's."""
    cfg = _small_cfg()
    ds = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    tables = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    o = torch.zeros((16, 3))
    d = torch.nn.functional.normalize(torch.ones((16, 3)), dim=1)
    md = torch.ones(16)
    kw = dict(bigtri_trans=ds.bigtri_trans, block_has_trans=ds.block_has_trans)
    with pytest.raises(ValueError, match="do not cover"):
        kernels.occlude_triangles(*tables, o, d, md, sb_sizes=(ds.triangle_blocks + 1,), **kw)
    with pytest.raises(ValueError, match="tri_saabb"):  # a superbox per entry of sb_sizes
        kernels.occlude_triangles(*tables[:3], torch.zeros((len(ds.sb_sizes) + 1, 8)), o, d, md,
                                  sb_sizes=ds.sb_sizes, **kw)
    for bad in (o.t().contiguous(), o.t().contiguous().t()):
        with pytest.raises(ValueError):
            kernels.occlude_triangles(*tables, bad, d, md, sb_sizes=ds.sb_sizes, **kw)
    got = kernels.occlude_triangles(*tables, o, d, md, sb_sizes=ds.sb_sizes, **kw)
    alone = kernels.occlude_triangles(*tables[:3], ds.tri_aabb, o, d, md, **kw)
    assert got[0].shape == (16,) and got[2].shape == (16, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, alone))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_kernel_build_is_keyed_by_sources(tmp_path, monkeypatch):
    """Each kernel builds from the package's csrc/ into the ignored build
    directory, under a name that changes with its source, header or flags."""
    assert sorted(kernels.KERNEL_SOURCES) == [
        "cast_triangles", "cast_triangles_stream", "light_shade", "occlude_triangles",
        "occlude_triangles_stream", "shade_eval", "shade_eval_rows"]
    assert set(kernels.COMMON_HEADERS) == {
        "rt_common.cuh", "rt_occlude.cuh", "rt_light.cuh", "rt_node.cuh"}
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


def test_seven_kernels_each_with_source_wrapper_and_twin():
    """One CUDA source, one C entry point, one wrapper, one launch count and
    one plain twin per TPU kernel; every file of csrc/ is a kernel's source
    or a header of the build hash, and includes nothing else."""
    import re

    assert len(kernels.KERNEL_SOURCES) == 7
    assert set(kernels.LAUNCHES) == set(kernels._ARGTYPES) == set(kernels.KERNEL_SOURCES)
    assert set(os.listdir(kernels.CSRC)) == (
        set(kernels.KERNEL_SOURCES.values()) | set(kernels.COMMON_HEADERS))
    for name, src in kernels.KERNEL_SOURCES.items():
        assert callable(getattr(kernels, name)), name
        assert callable(getattr(kernels, name + "_plain")), name
        symbol, argtypes = kernels._ARGTYPES[name]
        with open(os.path.join(kernels.CSRC, src)) as fh:
            text = fh.read()
        entry = re.search(r'extern "C" int (\w+)\(([^)]*)\)', text)
        assert entry and entry.group(1) == symbol == "rt_" + name, name
        assert len(entry.group(2).split(",")) == len(argtypes), name
        assert "pallas_kernels.py" in text and "sm_90a" in text, name
        assert "cudaGetLastError" in text, name
    for f in os.listdir(kernels.CSRC):
        with open(os.path.join(kernels.CSRC, f)) as fh:
            text = fh.read()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in kernels.COMMON_HEADERS, (f, inc)
        assert "atomicAdd" not in text, f  # f32 sums keep one order


@pytest.mark.parametrize("name", ["cast_triangles_stream", "occlude_triangles_stream",
                                  "cast_triangles", "shade_eval_rows", "occlude_triangles"])
def test_streamed_kernels_use_no_atomics(name):
    """The warp-per-ray kernels reduce across lanes with ballots, shuffles
    and `redux`, in a fixed order: their code (comments set aside), and that
    of the headers it includes, names no atomic operation."""
    import re

    todo, seen, code = [kernels.KERNEL_SOURCES[name]], set(), ""
    while todo:
        f = todo.pop()
        seen.add(f)
        with open(os.path.join(kernels.CSRC, f)) as fh:
            text = fh.read()
        todo += [h for h in re.findall(r'#include "([^"]+)"', text) if h not in seen]
        code += re.sub(r"//[^\n]*", "", text)
    assert "atomic" not in code.lower()
    for needed in ("__ballot_sync", "__shfl_sync", "threadIdx.x >> 5"):
        assert needed in code, needed


def test_sources_name_no_jax():
    """Neither the package nor chip_smoke.py imports JAX or the JAX package
    (a static scan beside the import check above)."""
    import re

    pkg = os.path.join(ROOT, "hslu_i", "ba_raytracing", "f2501_raytracer_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(pkg):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    bad = re.compile(r"^\s*(import jax|from jax|import jaxlib|from jaxlib"
                     r"|from hslu_i\.ba_raytracing\.f2501_raytracer_tpu[ .]"
                     r"|import hslu_i\.ba_raytracing\.f2501_raytracer_tpu[ .\n])", re.M)
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            assert not bad.search(fh.read()), f


def test_scene_level_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card reaches neither the
    twin nor a kernel."""
    pack = torch.zeros((2, 4, 32), device="meta")
    box = torch.zeros((2, 8), device="meta")
    o = torch.zeros((8, 3), device="meta")
    md = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.cast_triangles_stream(pack, box, box, o, o, sb_sizes=(1, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.occlude_triangles_stream(pack, box, box, o, o, md, sb_sizes=(1, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.occlude_triangles(torch.zeros((8, 32), device="meta"), pack, box, box, o, o, md)


def test_gpu_tests_are_marked():
    import test_torch_kernels_gpu as g

    tests = [v for k, v in vars(g).items() if k.startswith("test_")]
    assert tests
    for fn in tests:
        marks = {m.name for m in getattr(fn, "pytestmark", [])}
        assert "gpu" in marks, fn.__name__
    with open(os.path.join(ROOT, "pytest.ini")) as fh:
        assert "    gpu:" in fh.read()
