"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root, each configuration's file, each traffic mix (`traffic/<mix>.json`),
each scene (`scenes/<scene>.py`), each configuration's plain reference
(`reference/<module>.py`) and each per-layer metric's reader
(`layer_metrics/<metric>.py`). A cell or a metric is added by adding files
and entries; nothing here names one.

A configuration file may name its reference as `"reference": "<module>"`
(`whitted` without the key). The module exposes
`reference_frame(raw, render, width, height, seed, device, dtype=torch.float32)`,
which returns the frame as (H*W,) uint32 0xFFRRGGBB, row-major, 0 where
nothing was hit; it imports neither the port nor the JAX package."""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(cells: {', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, cell_: dict, root: str = ROOT) -> dict:
    """The configuration file of a cell, with its BENCHMARK.json entry under
    `entry`."""
    for c in bench["configs"]:
        if c["name"] == cell_["config"]:
            with open(os.path.join(root, c["file"])) as f:
                return dict(json.load(f), entry=c)
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: dict, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{cell_['traffic']}.json")) as f:
        return json.load(f)


def metrics(bench: dict, cell_: dict, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries this cell reports: those
    without a `workloads` key, and those that list the cell."""
    return [m for m in bench[kind] if cell_["name"] in m.get("workloads", [cell_["name"]])]


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene_module(name: str, bench_dir: str = BENCH_DIR):
    return _load(os.path.join(bench_dir, "scenes", f"{name}.py"), f"frame_bench_scene_{name}")


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The module that reads per-layer metric `metric`: `read(ctx)` returns a
    number or None (nothing to read), and optional `CAPTURE`, the kernel
    wrappers whose calls of the sampled tile it needs."""
    return _load(os.path.join(bench_dir, "layer_metrics", f"{metric}.py"),
                 "frame_bench_metric_" + metric.replace(".", "_").replace("-", "_"))


DEFAULT_REFERENCE = "whitted"


def reference(cfg: dict):
    """The plain reference module that configuration `cfg` names, imported
    as `reference.<module>` (so its relative imports work) from the
    `reference` package on `sys.path`, `frame_bench/reference/`. Raises
    ValueError, naming the modules there, for a name that is not one of them
    or whose module has no `reference_frame`."""
    name = cfg.get("reference", DEFAULT_REFERENCE)
    folder = importlib.import_module("reference").__path__[0]
    have = sorted(f[:-3] for f in os.listdir(folder) if f.endswith(".py") and f != "__init__.py")
    found = isinstance(name, str) and re.fullmatch("[A-Za-z0-9_]+", name) and name in have
    mod = importlib.import_module(f"reference.{name}") if found else None
    if not callable(getattr(mod, "reference_frame", None)):
        raise ValueError(f"configuration {cfg.get('name')!r} names the reference {name!r}: no module "
                         f"of {folder} with a reference_frame (modules: {', '.join(have)})")
    return mod
