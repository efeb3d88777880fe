"""The plain reference, taken as the harness takes it (`spec.reference`):
each configuration without a `reference` key gets `whitted`, it agrees with
the port's CPU twins on both configurations at a tiny size, its bfloat16
control fails the comparison, and it imports nothing of either package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fb_util
from framebench import compare, port, spec
from reference import whitted

W, H = 48, 40


def _scene(cell_name, seed):
    bench = spec.load_benchmark()
    cfg = spec.config(bench, spec.cell(bench, cell_name))
    return cfg, spec.scene_module(cfg["scene"]).build(W, H, seed, cfg["seed_offset_bound"])


def reference_frame(cfg, *args):
    return spec.reference(cfg).reference_frame(*args)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell_name", fb_util.CELLS)
def test_a_configuration_without_the_key_gets_whitted(cell_name):
    cfg, raw = _scene(cell_name, 5)
    assert "reference" not in cfg and spec.reference(cfg) is whitted
    got = reference_frame(cfg, raw, cfg["render"], W, H, 5, "cpu")
    want = whitted.reference_frame(raw, cfg["render"], W, H, 5, "cpu")
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("cell_name", fb_util.CELLS)
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_reference_agrees_with_the_ports_twins(cell_name, seed):
    cfg, raw = _scene(cell_name, seed)
    prog = port.Port(cfg["render"], W, H, seed, raw, "cpu")
    px, dropped, unfinished = prog.frame()
    assert (dropped, unfinished) == (0, 0)
    ref = reference_frame(cfg, raw, cfg["render"], W, H, seed, "cpu")
    numbers = compare.frame_numbers(px, ref)
    assert (px != 0).mean() > 0.5  # the frame shows the scene
    assert compare.passed(compare.checks(numbers, cfg["limits"])), numbers


@pytest.mark.parametrize("cell_name", fb_util.CELLS)
def test_bfloat16_control_fails(cell_name):
    """The control: the reference computed in bfloat16, the precision below
    the configuration's float32, put in the program's place."""
    cfg, raw = _scene(cell_name, 7)
    ref = reference_frame(cfg, raw, cfg["render"], W, H, 7, "cpu")
    control = reference_frame(cfg, raw, cfg["render"], W, H, 7, "cpu", torch.bfloat16)
    numbers = compare.frame_numbers(control, ref)
    assert not compare.passed(compare.checks(numbers, cfg["limits"])), numbers


def test_reference_imports_neither_package():
    """Each configuration's reference, looked up in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from framebench import spec; "
            "bench = spec.load_benchmark(); "
            "[spec.reference(spec.config(bench, c)) for c in bench['workloads']]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'hslu_i')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, fb_util.BENCH_DIR], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
