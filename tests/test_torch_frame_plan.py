"""PyTorch port: a renderer's frame plan, built once, and the u32 frame's
reorder on the device, on the CPU.

`RaytracerRenderer` builds `plan_frame(cfg)` and its device tables (the
padded tile-major order, the AA offsets and weights) at its first u32 frame
and keeps them; every later frame, and `get_pixel_color`, reuses them. The
tiles' pixels are scattered to row-major order on the device before the one
fetch. Checked here: later frames have the first frame's bits, the device
scatter gives the host expression's frame (`fb[plan.order] = px`) on one
device and on a mesh of two CPU entries, every frame's `frame.plan` span
carries its four counters, and two renderers keep their own plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import renderer
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.trace import trace_rays_tiled_u32_gen
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)

AA = dict(anti_aliasing=True, anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True)
# sizes that are no multiple of the 16-pixel patches of the tile-major order
FRAMES = {
    # 260 pixels in two tiles of 144: the last tile pads 28 slots
    "pool_padded": dict(width=20, height=13, reflections=True, refractions=True,
                        kernel_ray_tile=64, compaction_ratio=2, tile_rays=144, loop_chunk=4),
    # 70 pixels, their AA samples in tiles of 1024 rays, the last one padded
    "aa": dict(width=10, height=7, tile_rays=1024, **AA),
    # host-built rays, two tiles of 144 pixels, no padding
    "host_rays": dict(width=24, height=12, tile_rays=144, device_ray_gen=False),
}


def _renderer(frame, **kw):
    cfg = RenderConfig(**dict(FRAMES[frame], device_encode=True, **kw))
    return RaytracerRenderer(cfg, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """{frame: its device scene}; the scene does not depend on the plan."""
    out = {}
    for frame in FRAMES:
        r = _renderer(frame)
        out[frame] = r.device_scene(build("semesterbild", r.cfg))
    return out


def _host_reorder(cfg, scene):
    """The frame as the renderer assembled it on the host before: every tile
    traced with device-built rays, then `fb[plan.order] = px` (the frames of
    host-built rays have the same bits, tests/test_torch_renderer.py)."""
    plan = renderer.plan_frame(cfg)
    order, offsets = renderer.frame_order_device(cfg, plan, plan.n_tiles, "cpu")
    weights = torch.from_numpy(np.ascontiguousarray(plan.weights, np.float32))
    u32, dropped, unfinished = trace_rays_tiled_u32_gen(scene, cfg, order, offsets, weights,
                                                        n_tiles=plan.n_tiles, with_stats=True)
    assert int(dropped.sum()) == 0 and int(unfinished.sum()) == 0
    px = u32.reshape(-1).numpy().astype(np.uint32)
    fb = np.zeros((cfg.width * cfg.height,), np.uint32)
    fb[plan.order] = px[:cfg.width * cfg.height]
    return fb


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_later_frames_reuse_the_plan_and_keep_the_first_frames_bits(frame, scenes,
                                                                     monkeypatch):
    """Four frames of one renderer and `get_pixel_color` twice build one plan
    and upload its tables once; each frame has the bits of another
    renderer's first frame."""
    first = _renderer(frame).render_u32(scenes[frame])
    calls = {"plan_frame": 0, "frame_order_device": 0}

    def counted(name):
        fn = getattr(renderer, name)

        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    for name in calls:
        monkeypatch.setattr(renderer, name, counted(name))
    r = _renderer(frame)
    frames = [r.render_u32(scenes[frame]) for _ in range(4)]
    pixel = [r.get_pixel_color(scenes[frame], 3, 2) for _ in range(2)]
    assert calls == {"plan_frame": 1, "frame_order_device": 1}
    assert first.dtype == np.uint32 and first.shape == (r.cfg.width * r.cfg.height,)
    assert (first != 0).mean() > 0.5
    for fb in frames:
        assert fb.dtype == np.uint32 and np.array_equal(fb, first)
        assert r.last_dropped == 0 and r.last_unfinished == 0
    assert np.array_equal(pixel[0][0], pixel[1][0]) and pixel[0][1] == pixel[1][1]


@pytest.mark.parametrize("devices", [1, 2])
@pytest.mark.parametrize("frame", ["pool_padded", "aa"])
def test_device_reorder_gives_the_host_reorders_frame(frame, devices, scenes):
    r = _renderer(frame, devices=devices)
    assert (r.mesh is not None) == (devices > 1)
    want = _host_reorder(dataclasses.replace(r.cfg, devices=1), scenes[frame])
    for _ in range(2):
        assert np.array_equal(r.render_u32(scenes[frame]), want)
        assert r.last_dropped == 0 and r.last_unfinished == 0


@pytest.mark.parametrize("frame", ["pool_padded", "aa"])
def test_every_frame_records_its_plan_span_with_the_four_counters(frame, scenes):
    """The first frame builds the plan, the later ones reuse it: each records
    one `frame.plan` with the same counters (`primary_rays_per_pixel` reads
    them in every traced frame), and one `frame.reorder` before its
    `frame.fetch`."""
    r = _renderer(frame)
    plan = renderer.plan_frame(r.cfg)
    timing.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            r.render_u32(scenes[frame])
    rec = timing.take_spans()
    frames = [s for s in rec if s.name == "frame"]
    assert len(frames) == 3
    want = dict(aa_samples=r.cfg.total_aa_rays if r.cfg.anti_aliasing else 1,
                aa_distinct=plan.aa, rays=plan.n_tiles * plan.pix_per_tile * plan.aa,
                pixels=r.cfg.width * r.cfg.height)
    for f in frames:
        kids = {s.name: s for s in rec if s.parent == f.id and s.name != "tile"}
        assert sorted(kids) == ["frame.fetch", "frame.plan", "frame.reorder"]
        assert kids["frame.plan"].counters == want
        assert kids["frame.reorder"].end <= kids["frame.fetch"].start


def test_two_renderers_keep_their_own_plans(scenes):
    """Renderers of two configs, their frames in turns: each keeps its own
    plan and tables and renders its own frame."""
    ra, rb = _renderer("pool_padded"), _renderer("aa")
    want = {id(ra): _host_reorder(ra.cfg, scenes["pool_padded"]),
            id(rb): _host_reorder(rb.cfg, scenes["aa"])}
    for r, frame in [(ra, "pool_padded"), (rb, "aa")] * 2:
        assert np.array_equal(r.render_u32(scenes[frame]), want[id(r)])
    for r in (ra, rb):
        plan = renderer.plan_frame(r.cfg)
        assert np.array_equal(r.frame_plan.order, plan.order)
        assert np.array_equal(r.frame_plan.offsets, plan.offsets)
        assert r.frame_plan.n_tiles == plan.n_tiles
        order, offsets, weights = r._frame_tables
        assert order.shape == (plan.n_tiles * plan.pix_per_tile,)
        assert torch.equal(order[:plan.order.shape[0]], torch.from_numpy(plan.order))
        assert torch.equal(weights, torch.from_numpy(plan.weights))
    assert ra.frame_plan.aa == 1 and rb.frame_plan.aa > 1
