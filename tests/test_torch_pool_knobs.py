"""PyTorch port: the pool's knobs -- `stage_mode`, `commit_splits`,
`resort_secondary` (JAX ops/trace.py:716-760, 842-858, 921-967).

In the JAX package the stage modes and the commit splits only pick how a
TPU pays for the same rows and sums (tests/test_stage_modes.py); the port
accepts them and takes its one row scatter and one commit per chunk, so
frames are bit-identical to `scatter` and to one commit.
The Morton resort changes which rays share a service window and the order
of the commit's rows, so it is held to the JAX package's own resort at the
traced-colour bar (tests/test_pallas_kernels.py:83-84: `valid` identical;
rtol 2e-5, atol 2e-6), primary-hit knife edges set apart as in
tests/test_torch_trace.py.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import trace as jax_trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
from scenes import mixed_scene
from test_torch_packet import port_trace
from test_torch_renderer import moved_hits, one_torch_thread  # noqa: F401 (autouse)
from test_torch_trace import POOL_CFG, _rays, carry

# 32x24 = 768 rays at kernel_ray_tile 64, ratio 4: W = 192, chunks of 6
KNOBS_CFG = dict(POOL_CFG, width=32, height=24, kernel_ray_tile=64, compaction_ratio=4,
                 loop_chunk=6, max_nodes=24, weight_cutoff=0.0)


@pytest.fixture(scope="module")
def mixed():
    jcfg = JaxConfig(use_pallas=False, **KNOBS_CFG)
    jds = jax_build(mixed_scene(jcfg), jcfg)
    return jds, carry(jds)


@pytest.mark.parametrize("mode", ["gather", "unique"])
def test_stage_mode_frames_equal_scatter(mixed, mode):
    _, tds = mixed
    cfg = RenderConfig(**KNOBS_CFG)
    o, d = _rays(cfg)
    base = port_trace(tds, cfg, o, d)
    got = port_trace(tds, dataclasses.replace(cfg, stage_mode=mode), o, d)
    assert base[1].any() and base[0].max() > 0
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("splits", [2, 3, 8])
def test_commit_splits_frames_equal_one_commit(mixed, monkeypatch, splits):
    """2, 3 and 8 split counts (8 more than the chunk's 6 iterations): the
    same bits as one commit, and the same commits, one per chunk."""
    _, tds = mixed
    cfg = RenderConfig(**KNOBS_CFG)
    o, d = _rays(cfg)
    committed, real = [], trace._commit

    def commit(accum, pix, contrib):
        committed.append(pix.shape[0])
        return real(accum, pix, contrib)

    monkeypatch.setattr(trace, "_commit", commit)
    base = port_trace(tds, cfg, o, d)
    R = o.shape[0]
    W = (R // cfg.compaction_ratio) // cfg.kernel_ray_tile * cfg.kernel_ray_tile
    assert set(committed) == {cfg.loop_chunk * W} and len(committed) > 1
    one = list(committed)
    committed.clear()
    got = port_trace(tds, dataclasses.replace(cfg, commit_splits=splits), o, d)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)
    assert committed == one


def off_bar(jds, tds, kw, o, d, moved):
    """(port frame, rays off the traced-colour bar) of one config; `valid`
    identical but at the rays whose primary hit moved."""
    jcfg = JaxConfig(use_pallas=False, **kw)
    c_ref, v_ref, st_ref = jax_trace.trace_rays(jds, jcfg, jnp.asarray(o), jnp.asarray(d),
                                                with_stats=True)
    got = port_trace(tds, RenderConfig(**kw), o, d)
    np.testing.assert_array_equal(got[1][~moved], np.asarray(v_ref)[~moved])
    assert got[2] == int(st_ref["dropped"]) == 0
    return got, ~np.isclose(got[0], np.asarray(c_ref), rtol=2e-5, atol=2e-6).all(-1)


@pytest.mark.parametrize("scene_name", ["mixed", "translucent"])
def test_resort_secondary_matches_jax(scene_name, mixed):
    """Knife edges: a ray off the bar must have a moved primary hit (on
    translucent_scene one primary ray follows the seam of two triangles,
    tests/test_torch_trace.py), or be off the bar between the packages
    without the resort as well (the scene's own edges: a shadow ray near a
    glass sphere's silhouette, whose discriminant jitted XLA contracts into
    a fused multiply-add; tests/test_torch_light_shade.py); under 0.5% of
    the rays."""
    from scenes import translucent_scene

    if scene_name == "mixed":
        jds, tds = mixed
    else:
        jcfg = JaxConfig(use_pallas=False, **KNOBS_CFG)
        jds = jax_build(translucent_scene(jcfg), jcfg)
        tds = carry(jds)
    o, d = _rays(RenderConfig(**KNOBS_CFG))
    moved = moved_hits(jds, tds, o, d)
    (c, v, _), off = off_bar(jds, tds, dict(KNOBS_CFG, resort_secondary=True), o, d, moved)
    (c_plain, v_plain, _), off_plain = off_bar(jds, tds, KNOBS_CFG, o, d, moved)
    edge = moved | off_plain
    assert not (off & ~edge).any(), np.where(off & ~edge)
    assert off.sum() <= 0.005 * off.size, int(off.sum())
    # sorting moves rays between windows and the commit's rows, so the f32
    # sums may move: within the bar of the unsorted frame
    np.testing.assert_array_equal(v, v_plain)
    np.testing.assert_allclose(c_plain, c, rtol=2e-5, atol=2e-6)


def test_morton_order_puts_dead_lanes_last():
    rows = torch.zeros((6, trace.POOL_COLS))
    rows[:, trace.PK_O] = torch.tensor([[0.9, 0.9, 0.9], [0.0, 0.0, 0.0], [0.5, 0.1, 0.0],
                                        [0.0, 0.0, 0.0], [0.1, 0.5, 0.0], [0.2, 0.2, 0.2]])
    active = torch.tensor([True, True, True, False, True, True])
    order = trace._morton_order(rows, active).tolist()
    assert order[-1] == 3 and order[0] == 1
    assert order.index(2) < order.index(4)  # x is the lowest bit of a triple
    assert order.index(5) < order.index(0)
