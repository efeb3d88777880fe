"""The harness end to end on the CPU at a tiny size: the result's line, the
import check, the exits without a card or without the program, data found by
name, and `correct` coming out false with the timed path broken underneath.
The card's own run is the `gpu` test at the end."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fb_util
from framebench import cell

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return fb_util.bench_copy(tmp_path_factory.mktemp("fb"))


def _cpu_run(root, workload, seconds, trace):
    """A run of the copy at `root` in a fresh interpreter, its `frame_bench/`
    first on the path as run.py puts it, the card check skipped: (returncode,
    stdout, stderr)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from framebench import cell\n"
        "r = cell.run(sys.argv[3], 11, float(sys.argv[4]), sys.argv[5] == '1', device='cpu',\n"
        "             root=sys.argv[6], bench_dir=sys.argv[6] + '/frame_bench')\n"
        "bad = cell.forbidden_modules()\n"
        "if bad: print('loaded:', bad, file=sys.stderr); sys.exit(3)\n"
        "cell.emit(r)\n")
    out = subprocess.run([sys.executable, "-c", code, os.path.join(root, "frame_bench"), fb_util.ROOT,
                          workload, str(seconds), str(int(trace)), root],
                         capture_output=True, text=True, env=ENV, timeout=600)
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("workload", fb_util.CELLS)
def test_one_second_run_prints_the_contracts_line(copy, workload):
    rc, out, err = _cpu_run(copy, workload, 1, False)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    want = {"frame_ms", "setup_s"} | ({"frame_ms_p95"} if workload.startswith("soft") else set())
    assert set(res["metrics"]) == want
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    # the numbers compared, beside their limits, are standard error's last lines
    tail = [ln for ln in err.strip().splitlines() if ln.startswith("check ")]
    assert [ln.split()[1] for ln in tail] == list(res["checks"])
    assert err.strip().splitlines()[-len(tail):] == tail


def test_traced_run_adds_window_and_breakdown(copy):
    rc, out, err = _cpu_run(copy, "soft_shadows_1080p", 1, True)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == RESULT_KEYS | {"breakdown"}
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run has no device trace: no device metric is read from it
    assert res["metrics"] == {}


def test_forbidden_modules_compare_whole_components():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax", "jaxtyping", "hslu_i",
            "hslu_i.ba_raytracing.f2501_raytracer_tpu", "hslu_i.ba_raytracing.f2501_raytracer_tpu.ops",
            "hslu_i.ba_raytracing.f2501_raytracer_tpu_torch", "hslu_i.ba_raytracing"]
    assert cell.forbidden_modules(mods) == [
        "flax", "hslu_i.ba_raytracing.f2501_raytracer_tpu",
        "hslu_i.ba_raytracing.f2501_raytracer_tpu.ops", "jax", "jax.numpy", "jaxlib.xla"]


def _run_py(cwd):
    return subprocess.run([sys.executable, "frame_bench/run.py", "--workload", "soft_shadows_1080p",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=ENV, timeout=300)


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(fb_util.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_with_only_the_benchmark_exits_without_a_result(copy, tmp_path):
    bare = str(tmp_path / "bare")
    shutil.copytree(copy, bare)
    out = _run_py(bare)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cannot be imported" in out.stderr


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A cell and a metric added as files and entries, no file edited."""
    root = fb_util.bench_copy(tmp_path)
    fb = os.path.join(root, "frame_bench")
    with open(os.path.join(fb, "configs", "semesterbild_realistic.json")) as f:
        cfg = json.load(f)
    cfg.update(name="semesterbild_plain")
    cfg["render"] = {k: v for k, v in cfg["render"].items()
                     if k not in ("reflections", "light_reflections", "refractions")}
    with open(os.path.join(fb, "configs", "semesterbild_plain.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(fb, "traffic", "tiny.json"), "w") as f:
        json.dump({"width": 16, "height": 12, "trace_seconds": 0.1}, f)
    with open(os.path.join(fb, "layer_metrics", "frames_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.frames\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="semesterbild_plain",
                                 file="frame_bench/configs/semesterbild_plain.json"))
    bench["workloads"].append({"name": "plain_tiny", "config": "semesterbild_plain",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "device (H100)",
                               "moves": "frame_ms", "workloads": ["plain_tiny"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = fb_util.run_cpu(root, "plain_tiny", trace=True)
    assert res["correct"] and res["metrics"]["frames_traced"]["value"] >= 1


def _add_cell(root, config, workload, **changes):
    """A configuration (`semesterbild_soft_shadows`'s file with `changes`) and
    a cell that runs it under the copy's `frames_1080p`, added to the copy at
    `root` as a file and entries."""
    fb = os.path.join(root, "frame_bench")
    with open(os.path.join(fb, "configs", "semesterbild_soft_shadows.json")) as f:
        cfg = json.load(f)
    cfg.update(changes, name=config)
    with open(os.path.join(fb, "configs", f"{config}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][1], name=config,
                                 file=f"frame_bench/configs/{config}.json"))
    bench["workloads"].append({"name": workload, "config": config, "traffic": "frames_1080p",
                               "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


RECORDING_REFERENCE = """import sys

import torch

from . import whitted


def reference_frame(raw, render, width, height, seed, device, dtype=torch.float32):
    print(f"called {__name__} {width}x{height} seed {seed}", file=sys.stderr)
    return whitted.reference_frame(raw, render, width, height, seed, device, dtype)
"""


def test_new_config_names_its_own_reference(tmp_path):
    """A configuration that names a reference module of its own, both added
    as files and entries, no file of the copy edited: the run imports it as
    `reference.<module>` and compares the window's frame with its frame."""
    root = fb_util.bench_copy(tmp_path)
    with open(os.path.join(root, "frame_bench", "reference", "whitted_recorded.py"), "w") as f:
        f.write(RECORDING_REFERENCE)
    _add_cell(root, "semesterbild_recorded", "recorded_tiny", reference="whitted_recorded")
    rc, out, err = _cpu_run(root, "recorded_tiny", 1, False)
    assert rc == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert "called reference.whitted_recorded 32x24 seed 11" in err.splitlines()


@pytest.mark.parametrize("name", ["no_such_reference", "../reference/whitted", "geometry"])
def test_missing_reference_stops_the_run_before_its_first_frame(tmp_path, monkeypatch, name):
    """A name that is no reference module of `frame_bench/reference/` (none
    such, a path, a module without `reference_frame`) stops the run at
    set-up, before the port is built, naming the modules there."""
    from framebench import port

    root = fb_util.bench_copy(tmp_path)
    _add_cell(root, "semesterbild_missing", "missing_tiny", reference=name)
    built = []
    monkeypatch.setattr(port, "Port", lambda *a, **k: built.append(a))
    with pytest.raises(ValueError, match=r"'semesterbild_missing'.*\(modules: geometry, lights, whitted\)"):
        fb_util.run_cpu(root, "missing_tiny")
    assert built == []


# ---- the timed path broken underneath: `correct` must come out false ----

def _break(monkeypatch, fault):
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import renderer
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace

    if fault == "half_of_each_tile_left_out":
        real = trace.trace_rays

        def traced(scene, cfg, o, d, with_stats=False):  # every tile's first half untraced
            color, valid, stats = real(scene, cfg, o, d, with_stats=True)
            half = torch.arange(valid.shape[0]) < valid.shape[0] // 2
            color = torch.where(half[:, None], torch.zeros_like(color), color)
            valid = valid & ~half
            return (color, valid, stats) if with_stats else (color, valid)

        monkeypatch.setattr(trace, "trace_rays", traced)
    elif fault == "children_never_traced":  # the loop returns its state unchanged
        zero = torch.zeros((), dtype=torch.int64)
        monkeypatch.setattr(trace, "_run_stack", lambda scene, cfg, eps, contrib, *pushes: (
            contrib, zero, zero))
        monkeypatch.setattr(trace, "_run_pool", lambda scene, cfg, eps, R, contrib, *rows: (
            contrib, zero, zero))
    elif fault == "a_pixel_altered_in_one_frame":  # in the first timed frame's first tile
        real_render, real_encode = renderer.RaytracerRenderer.render_u32, trace.encode_pixels_u32
        n = {"frames": 0, "altered": False}

        def render(self, dscene):
            n["frames"] += 1
            return real_render(self, dscene)

        def encode(color, valid, w):
            out = real_encode(color, valid, w)
            if n["frames"] == 2 and not n["altered"]:  # frame 1 is the warm-up frame
                n["altered"] = True
                out = out.clone()
                out[5] ^= 0x404040
            return out

        monkeypatch.setattr(renderer.RaytracerRenderer, "render_u32", render)
        monkeypatch.setattr(trace, "encode_pixels_u32", encode)
    elif fault == "rays_dropped":
        real = renderer.RaytracerRenderer.render_u32

        def render(self, dscene):
            out = real(self, dscene)
            self.last_dropped = 1
            return out

        monkeypatch.setattr(renderer.RaytracerRenderer, "render_u32", render)


@pytest.mark.parametrize("fault", ["half_of_each_tile_left_out", "children_never_traced",
                                   "a_pixel_altered_in_one_frame", "rays_dropped"])
def test_broken_path_is_not_correct(copy, monkeypatch, fault):
    workload = "soft_shadows_1080p" if fault == "a_pixel_altered_in_one_frame" else "realistic_1080p"
    _break(monkeypatch, fault)
    res = fb_util.run_cpu(copy, workload, seconds=1.5)
    assert res["correct"] is False, res["checks"]


def test_seeds_change_the_frame_not_the_work(copy):
    """Two seeds render different frames; one seed renders the same bits."""
    from framebench import port, spec

    bench = spec.load_benchmark(copy)
    cfg = spec.config(bench, spec.cell(bench, "soft_shadows_1080p"), copy)
    frames = []
    for seed in (4, 4, 2**31 + 1):
        raw = spec.scene_module("semesterbild").build(24, 16, seed, cfg["seed_offset_bound"])
        frames.append(port.Port(cfg["render"], 24, 16, seed, raw, "cpu").frame()[0])
    assert np.array_equal(frames[0], frames[1]) and not np.array_equal(frames[0], frames[2])


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "frame_bench/run.py", "--workload", "soft_shadows_1080p",
                          "--seed", "12345", "--seconds", "2", "--trace", "0"],
                         cwd=fb_util.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
