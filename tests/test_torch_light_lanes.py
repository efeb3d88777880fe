"""PyTorch port: the light-lanes form of `shade_eval_rows` (a warp per ray
whose lanes take its lights; csrc/rt_node.cuh::rt_node_light_lanes).

Here, on the CPU: which form `kernels.node_form` gives a call by its ray and
light counts; the launch key of the form counting into an open capture and
added at each replay, and zeroed with the others; the chunk graphs' key
naming the form's threshold; the form's code shared by the wrapper and the
CUDA source. On the card (the `gpu` marker; the `cuda` fixture skips without
one): a replayed pool frame counts the form once a pool iteration at 140
lights and never at 5. The bits of the three forms are held against each
other in tests/test_torch_kernels_gpu.py. This file imports neither JAX nor
the JAX test helpers, so on the card it runs without the repository's
conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_light_lanes.py
"""

from __future__ import annotations

import os
import re

import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing

KEY = kernels.LIGHT_LANES_LAUNCHES


@pytest.mark.parametrize("n_rays, n_lights, form", [
    (3584, 140, kernels.LIGHT_LANES),   # extreme's pool
    (2048, 5, 1),                       # realistic's pool
    (1536, 95, kernels.LIGHT_LANES),    # reference_default's pool
    (0, 140, kernels.LIGHT_LANES),
    (kernels.PACKET_MIN_RAYS - 1, 140, kernels.LIGHT_LANES),
    (kernels.PACKET_MIN_RAYS, 140, 32),  # a tile's prologue: a ray per lane
    (262140, 140, 32),
    (131072, 5, 32),
    (131072, 50, 32),
])
def test_node_form_by_rays_and_lights(n_rays, n_lights, form):
    assert kernels.node_form(n_rays, n_lights) == form


def test_node_form_follows_the_threshold(monkeypatch):
    """The form changes at LIGHT_LANES_MIN_LIGHTS lights, below
    PACKET_MIN_RAYS rays only."""
    n = kernels.LIGHT_LANES_MIN_LIGHTS
    assert 5 < n <= 95
    assert kernels.node_form(2048, n - 1) == 1
    assert kernels.node_form(2048, n) == kernels.LIGHT_LANES
    monkeypatch.setattr(kernels, "LIGHT_LANES_MIN_LIGHTS", 1 << 30)
    assert kernels.node_form(3584, 140) == 1
    monkeypatch.setattr(kernels, "LIGHT_LANES_MIN_LIGHTS", 0)
    assert kernels.node_form(2048, 5) == kernels.LIGHT_LANES
    assert kernels.node_form(kernels.PACKET_MIN_RAYS, 5) == 32


def test_light_lanes_key_counts_into_a_capture_and_at_replay():
    """The form's key counts in the open capture's counts, not in LAUNCHES;
    each `count_launches` of those counts (a replay) adds them to LAUNCHES;
    `reset_launch_counts` zeroes it."""
    before = dict(kernels.LAUNCHES)
    try:
        with kernels.counting_into({}) as counts:
            kernels._count("shade_eval_rows")
            kernels._count(KEY)
            with kernels.counting_into(None):  # an eager call between two graphs
                kernels._count(KEY)
        assert counts == {"shade_eval_rows": 1, KEY: 1}
        assert kernels.LAUNCHES[KEY] == before[KEY] + 1
        assert kernels.LAUNCHES["shade_eval_rows"] == before["shade_eval_rows"]
        for _ in range(3):
            kernels.count_launches(counts)
        assert kernels.LAUNCHES[KEY] == before[KEY] + 4
        assert kernels.LAUNCHES["shade_eval_rows"] == before["shade_eval_rows"] + 3
        kernels.reset_launch_counts()
        assert kernels.LAUNCHES[KEY] == 0 and not any(kernels.LAUNCHES.values())
    finally:  # later tests in this process count from where they found it
        kernels.LAUNCHES.update(before)


def test_graph_key_names_the_threshold(monkeypatch):
    """A chunk graph holds for the form its launches took: the key changes
    with LIGHT_LANES_MIN_LIGHTS."""
    cfg = RenderConfig(width=24, height=12, reflections=True, refractions=True,
                       kernel_ray_tile=64, compaction_ratio=2, tile_rays=144)
    scene = RaytracerRenderer(cfg, device="cpu").device_scene(build("semesterbild", cfg))
    shape = (144, 64, 2, 1000, 1000)
    key = trace._graph_key(scene, cfg, 1e-4, *shape)
    assert kernels.LIGHT_LANES_MIN_LIGHTS in kernels.launch_settings()
    monkeypatch.setattr(kernels, "LIGHT_LANES_MIN_LIGHTS", kernels.LIGHT_LANES_MIN_LIGHTS + 1)
    assert trace._graph_key(scene, cfg, 1e-4, *shape) != key


def test_form_code_matches_the_cuda_source():
    """The wrapper's code of the form is the one the C entry point takes."""
    with open(os.path.join(kernels.CSRC, "rt_node.cuh")) as fh:
        m = re.search(r"#define RT_LIGHT_LANES (\d+)", fh.read())
    assert m and int(m.group(1)) == kernels.LIGHT_LANES
    assert kernels.LIGHT_LANES not in (1, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: pytest -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lights", ["5", "140"])
def test_replayed_frame_counts_the_form_once_a_pool_iteration(cuda, lights):
    """A replayed pool frame (two tiles of 4096 rays, the pool at W = 512,
    every call below PACKET_MIN_RAYS): at 140 lights (extreme's light
    clouds) each call takes the light-lanes form and counts it, one a pool
    iteration and one a tile; at 5 lights none does."""
    extra = dict(extreme_quality=True) if lights == "140" else {}
    cfg = RenderConfig(width=128, height=64, scene_backface_culling=True, tile_rays=4096,
                       kernel_ray_tile=128, compaction_ratio=8, loop_chunk=16, max_nodes=48,
                       weight_cutoff=1e-3, device_encode=True, reflections=True,
                       light_reflections=True, refractions=True, **extra)
    r = RaytracerRenderer(cfg, device=cuda)
    ds = r.device_scene(build("semesterbild", cfg))
    assert ds.n_lights == int(lights)
    for _ in range(3):  # the first chunk eager, the next captured, then replays
        r.render_u32(ds)
    kernels.reset_launch_counts()
    timing.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render_u32(ds)
    rec = timing.take_spans()
    chunks = [s.counters for s in rec if s.name == "pool.chunk"]
    tiles = sum(s.name == "tile" for s in rec)
    assert tiles > 1 and chunks and all(c["graph"] == 1 for c in chunks)
    iters = sum(c["iters"] for c in chunks)
    assert kernels.LAUNCHES["shade_eval_rows"] == iters + tiles
    assert kernels.LAUNCHES[KEY] == (iters + tiles if lights == "140" else 0)
