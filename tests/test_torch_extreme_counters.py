"""PyTorch port: the counters of the extreme-quality build's spans, on the CPU.

`frame.plan` counts the frame's AA samples (`aa_samples`, the table's rows),
the distinct ones traced a pixel (`aa_distinct`), the primary rays of all
its tiles, padding included (`rays`), and its pixels. Each `pool.chunk`
counts its lanes (`lanes`, iterations x the pool's width W) and the lanes
that serviced a pending ray (`live_lanes`): in each iteration as many as the
pool held at its start, at most W. Recording leaves the frame's bits as they
are, and a frame that does not record records nothing.

The build's flags are chip_smoke.py's `extreme` (bench.py:49-57). The plan
is checked at 20x15, chip_smoke.py's small size for the build, with the
tiles left untraced; the pool at 8x6, whose one tile takes the pool path at
the twins' small widths (chip_smoke.py's TWIN_SMALL) in seconds.
"""

from __future__ import annotations

import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import renderer
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)

EXTREME = dict(reflections=True, light_reflections=True, refractions=True,
               anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True,
               extreme_quality=True, high_quality_model=True, scene_backface_culling=True,
               tile_rays=262144, max_nodes=48, weight_cutoff=1e-3, device_encode=True)
TWIN_SMALL = dict(kernel_ray_tile=64, compaction_ratio=8, loop_chunk=8)


def _profiled():
    """A CPU profile: a frame rendered inside records its spans."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_plan_counts_the_frames_samples_rays_and_pixels(monkeypatch):
    cfg = RenderConfig(width=20, height=15, **EXTREME)
    plan = renderer.plan_frame(cfg)

    def untraced(scene, cfg, order_group, offsets, aa_weights, n_tiles, with_stats=False):
        zeros = torch.zeros((n_tiles,), dtype=torch.int64)
        return torch.zeros((n_tiles, plan.pix_per_tile), dtype=torch.int64), zeros, zeros

    monkeypatch.setattr(renderer, "trace_rays_tiled_u32_gen", untraced)
    r = RaytracerRenderer(cfg, device="cpu")
    scene = r.device_scene(build("semesterbild", cfg))
    timing.take_spans()
    with _profiled():
        r.render_u32(scene)
    (sp,) = [s for s in timing.take_spans() if s.name == "frame.plan"]
    assert plan.aa == 17 and plan.n_tiles >= 1
    assert sp.counters == {"aa_samples": 24, "aa_distinct": 17, "pixels": 300,
                           "rays": plan.n_tiles * plan.pix_per_tile * 17}
    assert sp.counters["rays"] >= 300 * 17


def test_pool_counts_its_live_lanes(monkeypatch):
    cfg = RenderConfig(width=8, height=6, **EXTREME, **TWIN_SMALL)
    plan = renderer.plan_frame(cfg)
    R = plan.pix_per_tile * plan.aa
    W = max((R // 8) // 64 * 64, 64)
    assert plan.n_tiles == 1 and R >= 64 * 8  # one tile, on the pool path
    r = RaytracerRenderer(cfg, device="cpu")
    scene = r.device_scene(build("semesterbild", cfg))
    timing.take_spans()
    off = r.render_u32(scene)
    assert timing.take_spans() == [] and not timing.ON

    # the pool's count at each iteration's start: the prologue's append,
    # then each iteration's but the last
    counts = []
    append = trace._pool_append

    def counted(pool, start, cand, m):
        out = append(pool, start, cand, m)
        counts.append(int(out))
        return out

    monkeypatch.setattr(trace, "_pool_append", counted)
    with _profiled():
        on = r.render_u32(scene)
    rec = timing.take_spans()
    assert (r.last_dropped, r.last_unfinished) == (0, 0)
    assert on.tobytes() == off.tobytes()
    chunks = [s.counters for s in rec if s.name == "pool.chunk"]
    assert len(chunks) >= 2
    for c in chunks:
        assert c["lanes"] == c["iters"] * W == 8 * W
        assert 0 <= c["live_lanes"] <= c["lanes"]
    assert len(counts) == sum(c["iters"] for c in chunks) + 1
    assert sum(c["live_lanes"] for c in chunks) == sum(min(n, W) for n in counts[:-1]) > 0
