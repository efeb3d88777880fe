"""The extreme-quality cell (`extreme_480x270`) on the CPU: its plain
reference (`whitted_hq`) against the port's twins, its bfloat16 control, its
folded samples against all 24, its imports and its AA table against the
port's; the cell run end to end through the harness, timed and traced, with
its three per-layer metrics; and those readers reading nothing on spans or
calls that lack what they read.

The port renders these small frames at the twins' small widths
(kernel_ray_tile 64, compaction 8, loop chunk 8, as chip_smoke.py's twins
do): the engine's batching changes no pixel, and it puts a frame of a few
hundred pixels on the pool path in seconds."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import fb_util
from framebench import cell, compare, port, spec, tracing
from framebench.spans import Span
from framebench.tracing import Event
from reference import whitted, whitted_hq

CELL = "extreme_480x270"
W, H = 24, 16
SMALL_ENGINE = dict(kernel_ray_tile=64, compaction_ratio=8, loop_chunk=8)
NEW_METRICS = ("primary_rays_per_pixel", "pool_live_lane_pct", "shade_eval_rows_pool_roofline")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _cfg():
    bench = spec.load_benchmark()
    return spec.config(bench, spec.cell(bench, CELL))


def _raw(cfg, w, h, seed):
    return spec.scene_module(cfg["scene"]).build(w, h, seed, cfg["seed_offset_bound"])


def test_the_configuration_names_whitted_hq_at_the_builds_tiers():
    cfg = _cfg()
    assert spec.reference(cfg) is whitted_hq
    t = whitted_hq.tiers(cfg["render"])
    assert t["depths"] == (cfg["depth_limits"]["reflection"], cfg["depth_limits"]["refraction"])
    assert (t["per_light"], t["samples"], t["aa"], t["soft"]) == (28, 24, True, True)
    ref = whitted_hq.Reference(_raw(cfg, 8, 6, 1), cfg["render"], 8, 6, 1, "cpu")
    assert (ref.refl_max, ref.refr_max) == (21, 21)
    assert ref.lpos.shape[0] == 5 * 28 and ref.offsets.shape[0] == 17
    assert float(ref.weights.sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_reference_agrees_with_the_ports_twins(seed):
    cfg = _cfg()
    raw = _raw(cfg, W, H, seed)
    prog = port.Port(dict(cfg["render"], **SMALL_ENGINE), W, H, seed, raw, "cpu")
    px, dropped, unfinished = prog.frame()
    assert (dropped, unfinished) == (0, 0)
    ref = whitted_hq.reference_frame(raw, cfg["render"], W, H, seed, "cpu")
    numbers = compare.frame_numbers(px, ref)
    assert (px != 0).mean() > 0.5  # the frame shows the scene
    assert compare.passed(compare.checks(numbers, cfg["limits"])), numbers


def test_bfloat16_control_fails():
    """The control: the reference computed in bfloat16, the precision below
    the configuration's float32, put in the program's place (at 8x6: the
    CPU's bfloat16 is slow)."""
    cfg = _cfg()
    raw = _raw(cfg, 8, 6, 7)
    ref = whitted_hq.reference_frame(raw, cfg["render"], 8, 6, 7, "cpu")
    control = whitted_hq.reference_frame(raw, cfg["render"], 8, 6, 7, "cpu", torch.bfloat16)
    numbers = compare.frame_numbers(control, ref)
    assert not compare.passed(compare.checks(numbers, cfg["limits"])), numbers


def test_folded_samples_give_the_frame_of_all_24():
    """The eight [1,1] rows traced once at weight 8/24 against each traced
    at 1/24: the sums differ by rounding only, within one level of 255."""
    cfg = _cfg()
    raw = _raw(cfg, 12, 8, 3)
    folded = whitted_hq.Reference(raw, cfg["render"], 12, 8, 3, "cpu")
    every = whitted_hq.Reference(raw, cfg["render"], 12, 8, 3, "cpu", dedupe=False)
    assert (folded.offsets.shape[0], every.offsets.shape[0]) == (17, 24)
    a = whitted.encode_u32(*folded.render())
    b = whitted.encode_u32(*every.render())
    assert np.array_equal(a != 0, b != 0) and (a != 0).any()
    gap = np.abs(compare._rgb(a) - compare._rgb(b))
    assert gap.max() <= 1


def test_reference_imports_neither_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from framebench import spec; "
            "bench = spec.load_benchmark(); "
            f"m = spec.reference(spec.config(bench, spec.cell(bench, {CELL!r}))); "
            "assert m.__name__ == 'reference.whitted_hq', m; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'hslu_i')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, fb_util.BENCH_DIR], capture_output=True,
                         text=True, env=env, cwd=fb_util.BENCH_DIR, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_aa_table_is_the_ports(seed):
    """The reference works its table out for itself; the port's is
    ops/camera.py's. Also at plain AA (9 samples, 16 rows)."""
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RenderConfig
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import camera

    render = _cfg()["render"]
    plain_aa = {k: v for k, v in render.items() if k not in ("extreme_quality", "high_quality_model")}
    for r, total, distinct in ((render, 24, 17), (plain_aa, 16, 9)):
        pc = RenderConfig(width=480, height=270, seed=seed, **r)
        ours = whitted_hq.aa_offsets(r, 480, 270, seed)
        assert ours.shape == (total, 3) and np.array_equal(ours, camera.antialiasing_offsets(pc))
        rows, weights = whitted_hq.fold(ours)
        prows, pweights = camera.antialiasing_weighted_offsets(pc)
        assert rows.shape[0] == distinct
        assert np.array_equal(rows, prows) and np.array_equal(weights, pweights)


def _stand_in_device(monkeypatch):
    """What a card's trace would give a CPU run: a device operation in the
    window (so the spans are read) and a device time for each sampled call
    (1 ms), with the sampled tile the frame's first (tile 0)."""
    events_from_profile = tracing.events_from_profile

    def events(prof):
        ev = events_from_profile(prof)
        lo, hi = tracing.window_of(ev)
        return ev + [Event("stand_in_kernel", "kernel", (lo + hi) / 2, 1e-6)]

    def device_times(cap, events, wrapper_of):
        for calls in cap.sampled.values():
            for c in calls:
                c["device_s"] = 1e-3

    monkeypatch.setattr(tracing, "events_from_profile", events)
    monkeypatch.setattr(cell, "_device_times", device_times)
    monkeypatch.setattr(cell, "SAMPLE_TILE", 0)


def test_one_second_run_of_the_cell_reads_its_metrics(tmp_path, monkeypatch):
    """The cell at 8x6 through the harness (one tile of 60 pixels x 17
    samples, the pool at W = 64): timed, `correct`; traced, the three new
    metrics."""
    root = fb_util.bench_copy(tmp_path, width=8, height=6, trace_seconds=0.2)
    path = os.path.join(root, "frame_bench", "configs", "semesterbild_extreme.json")
    with open(path) as f:
        c = json.load(f)
    c["render"].update(SMALL_ENGINE)
    with open(path, "w") as f:
        json.dump(c, f)
    timed = fb_util.run_cpu(root, CELL, seconds=1)
    assert timed["correct"] is True and timed["failed"] == 0 and timed["attempted"] >= 1
    assert set(timed["metrics"]) == {"frame_ms", "setup_s"}

    _stand_in_device(monkeypatch)
    traced = fb_util.run_cpu(root, CELL, seconds=1, trace=True)
    assert traced["correct"] is True and traced["failed"] == 0
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    assert set(got) == set(NEW_METRICS)
    assert got["primary_rays_per_pixel"] == pytest.approx(60 * 17 / 48)
    assert 0 < got["pool_live_lane_pct"] <= 100
    assert 0 < got["shade_eval_rows_pool_roofline"] <= 100


def _frame_spans(plan_counters, chunk_counters):
    rec = [Span("frame", 0.0, 10.0, 1, None, 1, {}),
           Span("frame.plan", 0.0, 1.0, 2, 1, 1, plan_counters),
           Span("tile", 1.0, 9.0, 3, 1, 1, {})]
    rec += [Span("pool.chunk", 2.0 + i, 2.5 + i, 4 + i, 3, 1, c) for i, c in enumerate(chunk_counters)]
    return rec


def _read(metric, rec, captured=None):
    ctx = types.SimpleNamespace(events=[Event("k", "kernel", 0.5, 0.5)], window=(0.0, 10.0),
                                window_s=10.0, frames=1, captured=captured or {})
    ctx.spans = rec  # as `spans.of` leaves them once taken from the port
    return spec.reader(metric, fb_util.BENCH_DIR).read(ctx)


def test_span_readers_read_their_counters_and_nothing_without_them():
    plan = {"aa_samples": 24, "aa_distinct": 17, "rays": 2359260, "pixels": 129600}
    chunks = [{"iters": 4, "live_iters": 4, "lanes": 400, "live_lanes": 300},
              {"iters": 4, "live_iters": 1, "lanes": 400, "live_lanes": 20}]
    rec = _frame_spans(plan, chunks)
    assert _read("primary_rays_per_pixel", rec) == pytest.approx(2359260 / 129600)
    assert _read("pool_live_lane_pct", rec) == pytest.approx(100 * 320 / 800)
    # the parent's port: no plan counters, chunks without lanes
    old = _frame_spans({}, [{"iters": 4, "live_iters": 4, "graph": 1}])
    assert _read("primary_rays_per_pixel", old) is None
    assert _read("pool_live_lane_pct", old) is None
    assert _read("pool_live_lane_pct", _frame_spans(plan, [])) is None  # no pool
    assert _read("primary_rays_per_pixel", []) is None
    # two `frame` spans where the harness traced one
    assert _read("primary_rays_per_pixel", rec + rec[:1]) is None
    assert _read("pool_live_lane_pct", rec + rec[:1]) is None


def test_pool_roofline_reads_nothing_without_pool_calls():
    """Only the tile's prologue (the widest call), or no call: nothing."""
    prologue = {"args": (None,) * 5 + (torch.zeros((1024, 3)),), "kw": {}, "out": (),
                "device_s": 1e-3}
    assert _read("shade_eval_rows_pool_roofline", [], {}) is None
    assert _read("shade_eval_rows_pool_roofline", [], {"shade_eval_rows": [prologue]}) is None
