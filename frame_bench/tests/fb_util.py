"""Shared helpers of the frame benchmark's tests: paths, and a temporary
copy of the benchmark whose traffic renders a tiny frame on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("realistic_1080p", "soft_shadows_1080p")


def bench_copy(dst, width=32, height=24, trace_seconds=0.2) -> str:
    """BENCHMARK.json and frame_bench/ copied under `dst`, every traffic mix
    cut to width x height; returns the copy's root."""
    root = os.path.join(str(dst), "checkout")
    shutil.copytree(BENCH_DIR, os.path.join(root, "frame_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    tdir = os.path.join(root, "frame_bench", "traffic")
    for f in os.listdir(tdir):
        path = os.path.join(tdir, f)
        with open(path) as fh:
            t = json.load(fh)
        t.update(width=width, height=height, trace_seconds=trace_seconds)
        with open(path, "w") as fh:
            json.dump(t, fh)
    return root


def run_cpu(root, workload, seed=3, seconds=0.5, trace=False):
    """One run of the copy at `root` on the CPU, through the harness's run."""
    from framebench import cell

    return cell.run(workload, seed, seconds, trace, device="cpu", root=root,
                    bench_dir=os.path.join(root, "frame_bench"), log=lambda m: None)
