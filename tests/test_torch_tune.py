"""PyTorch port: `autotune` (tune.py), the overlapped fetch's schedule and
the u32 frame's launch groups, against the JAX package and against one
group.

`fetch_schedule` is the JAX package's function copied: the same sizes for
every tile count and alignment. The launch groups (`tiles_per_program`, or
the `fetch_groups` schedule with or without `fetch_taper`) only cut the
tiles into groups whose pixels are fetched one after another, so every
grouping gives the frame of one group, bit for bit (JAX
tests/test_renderer_layout.py). `autotune` returns the candidate with the
least time, and the candidates' frames are the same image: the block size
only regroups the scans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu.renderer import (
    fetch_schedule as jax_fetch_schedule,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (
    RaytracerRenderer,
    RenderConfig,
    TuneResult,
    autotune,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import (
    fetch_schedule,
    launch_groups,
    plan_frame,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene
from scenes import mixed_scene
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_trace import POOL_CFG, carry


@pytest.mark.parametrize("align", [1, 2, 4])
def test_fetch_schedule_matches_jax(align):
    for n in range(align, 41, align):
        for groups in (1, 2, 3, 8, 16):
            got = fetch_schedule(n, max_groups=groups, align=align)
            assert got == jax_fetch_schedule(n, max_groups=groups, align=align), (n, groups)
            assert sum(got) == n and len(set(got)) <= 2
    with pytest.raises(ValueError):
        fetch_schedule(5, align=2)


def test_launch_groups_give_one_frame():
    """A 7-tile u32 frame: one group, the tapered 8-way schedule, a uniform
    split that divides it, one that does not (one group), and
    `tiles_per_program` groups with a ragged last one."""
    from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build

    kw = dict(POOL_CFG, width=24, height=18, tile_rays=64, device_encode=True,
              fetch_groups=1)
    cfg = RenderConfig(**kw)
    jcfg = JaxConfig(use_pallas=False, **kw)
    ds = carry(jax_build(mixed_scene(jcfg), jcfg))
    n_tiles = plan_frame(cfg).n_tiles
    assert n_tiles == 7
    cases = {
        "taper8": (dict(fetch_groups=8), [1] * 7),
        "uniform7": (dict(fetch_groups=7, fetch_taper=False), [1] * 7),
        "uniform3": (dict(fetch_groups=3, fetch_taper=False), [7]),
        "taper3": (dict(fetch_groups=3), [3, 2, 2]),
        "tiles_per_program": (dict(tiles_per_program=3), [3, 3, 1]),
    }
    one = RaytracerRenderer(cfg, device="cpu")
    base = one.render_u32(ds)
    assert launch_groups(cfg, n_tiles) == [7] and (base != 0).mean() > 0.5
    for name, (knobs, sizes) in cases.items():
        c = dataclasses.replace(cfg, **knobs)
        assert launch_groups(c, n_tiles) == sizes, name
        r = RaytracerRenderer(c, device="cpu")
        np.testing.assert_array_equal(r.render_u32(ds), base, err_msg=name)
        assert r.last_dropped == one.last_dropped == 0


def test_autotune_picks_the_fastest_candidate():
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build

    cfg = RenderConfig(width=24, height=20, tile_rays=480, reflections=True, refractions=True,
                       max_nodes=16, loop_chunk=8)
    scene = build("semesterbild", cfg)
    assert isinstance(scene, Scene)
    res = autotune(scene, cfg, candidates=(32, 128), repeats=1, tile=480, device="cpu")
    assert isinstance(res, TuneResult)
    assert set(res.timings_ms) == {32, 128} and res.tuned_block in (32, 128)
    assert res.timings_ms[res.tuned_block] == min(res.timings_ms.values())
    assert res.cfg.triangle_block == res.tuned_block == res.device_scene.tri_block
    assert res.device_scene.triangle_blocks > 1 or res.tuned_block == 128
    # the tuned frame and the other candidate's: the same image
    other = dataclasses.replace(cfg, triangle_block=128 if res.tuned_block == 32 else 32)
    img_a = RaytracerRenderer(res.cfg, device="cpu").render_device(res.device_scene)
    img_b = RaytracerRenderer(other, device="cpu").render(scene)
    np.testing.assert_array_equal(img_a.valid, img_b.valid)
    np.testing.assert_array_equal(img_a.color, img_b.color)
