"""PyTorch port: the `unfinished` count beside `dropped`, on the CPU.

`dropped` counts the secondary rays a full pool or stack refuses (the JAX
package's count; its parity with JAX is held by tests/test_torch_trace.py and
tests/test_torch_stack.py). `unfinished` counts the rays still in the pool,
or on the stacks, when the loop's iteration cap (`max_nodes`) ended it, which
no one traced: a frame ran to its depth only where it is 0. Held here on
both loops, through `trace_rays(with_stats=True)`, every frame path of the
renderer (u32, f32, progressive) and a mesh of two CPU entries: a loop cut
by `max_nodes=1` reports rays left, an uncut one reports 0, with the same
`dropped` either way.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)

# 24x12 rays: the pool at W = 64 (288 >= kernel_ray_tile * ratio), or the
# per-ray stack (compaction_ratio 1)
BASE = dict(width=24, height=12, reflections=True, refractions=True, kernel_ray_tile=64,
            loop_chunk=2)
LOOPS = {"pool": dict(compaction_ratio=2), "stack": dict(compaction_ratio=1)}


def _frame_rays(cfg):
    cam = cfg.camera
    idx = torch.arange(cfg.width * cfg.height)
    px = (idx % cfg.width).float() * cam.w2s_width
    py = torch.div(idx, cfg.width, rounding_mode="floor").float() * cam.w2s_height
    o = torch.stack([px, py, torch.zeros_like(px)], -1)
    return o, o - torch.tensor(cam.render_ray_focus)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_trace_rays_counts_the_rays_left_at_the_cap(loop):
    stats = {}
    for cut in (False, True):
        cfg = RenderConfig(**BASE, **LOOPS[loop], **(dict(max_nodes=1) if cut else {}))
        scene = RaytracerRenderer(cfg, device="cpu").device_scene(build("semesterbild", cfg))
        _, _, st = trace.trace_rays(scene, cfg, *_frame_rays(cfg), with_stats=True)
        assert set(st) == {"dropped", "unfinished"}
        stats[cut] = {k: int(v) for k, v in st.items()}
    assert stats[False] == {"dropped": 0, "unfinished": 0}, stats
    assert stats[True]["unfinished"] > 0 and stats[True]["dropped"] == 0, stats


@pytest.mark.parametrize("path", ["u32", "f32", "progressive", "mesh"])
def test_the_renderer_reports_unfinished_on_every_path(path):
    """The pool loop's frame through each of the renderer's paths: the
    count of the cut frame on every one (one tile: the same rays), 0
    uncut."""
    counts = {}
    for cut in (False, True):
        cfg = RenderConfig(**BASE, **LOOPS["pool"], device_encode=path in ("u32", "mesh"),
                           **(dict(max_nodes=1) if cut else {}))
        if path == "mesh":
            cfg = dataclasses.replace(cfg, devices=2)
        r = RaytracerRenderer(cfg, device="cpu")
        scene = r.device_scene(build("semesterbild", cfg))
        if path == "u32":
            r.render_u32(scene)
        elif path == "progressive":
            r.render_device(scene, progress=lambda buf, done: None)
        else:
            r.render_device(scene)
        counts[cut] = (r.last_dropped, r.last_unfinished)
    assert counts[False] == (0, 0), counts
    assert counts[True][0] == 0 and counts[True][1] > 0, counts
