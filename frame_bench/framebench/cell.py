"""One run of one cell: set-up, the timed (or traced) window, the comparison
with the reference, and the result's line.

Order: find the plain reference the configuration names (`spec.reference`;
a bad name stops the run here), build the raw scene from the seed, hand it
to the port, upload it, render the warm-up frame (the run's first frame; it
builds and loads every kernel and fills every cache the cell's shapes use),
then measure. Once the window has closed the peak memory is read, the
port's state freed, and the reference renders the same scene on the same
device in float32.
"""

from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import time
import types
from collections import Counter, defaultdict

import numpy as np
import torch

from . import compare, spec, tracing, window

JAX_PACKAGE = ("hslu_i", "ba_raytracing", "f2501_raytracer_tpu")
FORBIDDEN_TOP = ("jax", "jaxlib", "flax")
# the tile of the first traced frame whose kernel calls the roofline
# readers take: a tile-major band through the middle of a 1080p frame
SAMPLE_TILE = 3


def forbidden_modules(modules=None) -> list:
    """Loaded modules that are JAX or the JAX package, compared by whole
    dotted components (`f2501_raytracer_tpu_torch` is the port)."""
    out = []
    for name in sorted(modules if modules is not None else sys.modules):
        parts = name.split(".")
        if parts[0] in FORBIDDEN_TOP or tuple(parts[:3]) == JAX_PACKAGE:
            out.append(name)
    return out


def power_limit_w():
    """The card's power limit by nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class _Capture:
    """Tiles and kernel-wrapper calls seen while frames are traced."""

    def __init__(self):
        self.frame, self.tile = -1, -1
        self.calls = defaultdict(int)
        self.sampled = defaultdict(list)

    def on_tile(self):
        self.tile += 1

    def on_call(self, wrapper, args, kw, out):
        if self.frame == 0 and self.tile == SAMPLE_TILE:
            self.sampled[wrapper].append(dict(args=args, kw=kw, out=out,
                                              index=self.calls[wrapper]))
        self.calls[wrapper] += 1

    def framed(self, frame):
        def run():
            self.frame += 1
            self.tile = -1
            return frame()
        return run


def _device_times(cap: _Capture, events, wrapper_of):
    """Each sampled call's device seconds, when the trace holds exactly one
    kernel per call of its wrapper (otherwise left None)."""
    by_wrapper = defaultdict(list)
    for e in sorted((e for e in events if e.kind == "kernel"), key=lambda e: e.start):
        w = wrapper_of(e.name)
        if w:
            by_wrapper[w].append(e.dur)
    for w, calls in cap.sampled.items():
        durs = by_wrapper.get(w, [])
        for c in calls:
            c["device_s"] = durs[c["index"]] if len(durs) == cap.calls[w] else None


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start=None, root=spec.ROOT, bench_dir=spec.BENCH_DIR, log=None) -> dict:
    """One run; returns the result's object (the last line's keys)."""
    t_start = time.monotonic() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(bench, cell, root)
    reference = spec.reference(cfg)
    traffic = spec.traffic(cell, bench_dir)
    W, H = int(traffic["width"]), int(traffic["height"])
    raw = spec.scene_module(cfg["scene"], bench_dir).build(W, H, seed, cfg["seed_offset_bound"])
    from . import port as port_mod  # the system under test

    dev = torch.device(device)
    prog = port_mod.Port(cfg["render"], W, H, seed, raw, dev)
    first, dropped, unfinished = prog.frame()
    for _ in range(int(traffic.get("warmup_frames", 1)) - 1):
        prog.frame()
    frames = window.Frames(first, np.random.default_rng([int(seed), 0xF7A3]))
    setup_s = time.monotonic() - t_start
    log(f"set-up {setup_s:.3f} s; warm-up frame dropped {dropped}, unfinished {unfinished}, "
        f"sha256 {hashlib.sha256(first.tobytes()).hexdigest()[:16]}")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"])}
    readers = {m["name"]: spec.reader(m["name"], bench_dir)
               for m in spec.metrics(bench, cell, "per_layer")} if trace else {}
    breakdown = None
    if trace:
        cap = _Capture()
        wrappers = sorted({w for r in readers.values() for w in getattr(r, "CAPTURE", ())})
        before = prog.counters()
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CUDA if dev.type == "cuda" else act.CPU])
        with prog.hooks(cap.on_tile, wrappers, cap.on_call):
            wall = window.traced(cap.framed(prog.frame), frames,
                                 float(traffic.get("trace_seconds", 1.0)), prof,
                                 torch.profiler.record_function(tracing.WINDOW_MARK))
        counters = {k: v - before.get(k, 0) for k, v in prog.counters().items()}
        events = tracing.events_from_profile(prof)
        del prof
        win = tracing.window_of(events)
        _device_times(cap, events, port_mod.wrapper_of)
        ctx = types.SimpleNamespace(events=events, window=win, window_s=win[1] - win[0],
                                    frames=len(frames.walls),
                                    counters=counters, captured=cap.sampled,
                                    wrapper_of=port_mod.wrapper_of)
        device_info["busy_s"] = tracing.busy_seconds(events, win)
        device_info["window_s"] = ctx.window_s
        breakdown = {"device_ops": tracing.top(tracing.device_seconds_by_name(events, win)),
                     "idle_gaps": tracing.top(tracing.idle_gaps(events, win))}
        log(f"traced {ctx.frames} frames in {wall:.3f} s: {len(events)} events "
            f"{dict(Counter(e.kind for e in events))}, "
            f"device busy {device_info['busy_s']:.4f} of {ctx.window_s:.4f} s")
    else:
        window_s = window.timed(prog.frame, frames, seconds)
        log(f"window {window_s:.3f} s, {len(frames.walls)} frames")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        device_info["power_limit_w"] = power_limit_w()
    else:
        device_info["memory_peak_bytes"] = 0

    metrics = {}
    if trace:
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name, r in readers.items():
            value = r.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        del ctx, events, cap
    else:
        walls_ms = [w * 1e3 for w in frames.walls]
        e2e = {"frame_ms": window_s * 1e3 / len(walls_ms),
               "frame_ms_p95": float(np.percentile(walls_ms, 95)), "setup_s": setup_s}
        for m in spec.metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
        log("frame walls ms: " + " ".join(f"{w:.3f}" for w in walls_ms))

    sample = frames.sample
    prog.close()
    del prog, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    ref = reference.reference_frame(raw, cfg["render"], W, H, seed, dev)
    numbers = compare.frame_numbers(sample, ref)
    numbers["frames_failed"] = frames.failed
    checked = compare.checks(numbers, dict(cfg["limits"], frames_failed=0))
    log(f"reference {time.monotonic() - t_ref:.3f} s; failed frames {frames.bad}")
    return {
        "correct": compare.passed(checked),
        "attempted": len(frames.walls),
        "failed": frames.failed,
        "metrics": metrics,
        "device": device_info,
        **({"breakdown": breakdown} if breakdown else {}),
        "checks": checked,
    }


def emit(result: dict, log=None) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
