"""PyTorch port: the package's surface against the JAX package's, on the CPU.

* `utils` re-exports `RenderTiming` and `TileStats` (JAX utils/__init__.py);
* `ops.vecmath` has `cross`, `mag`, `lerp` and the `Ray` record (`new`,
  `at`, `invalid_value`; JAX ops/vecmath.py:24-93), each called on small
  seeded tensors against the JAX function on the same numpy inputs;
* `ops` imports its seven submodules (JAX ops/__init__.py), with no import
  cycle through `ops.kernels`: checked in a fresh process, which also finds
  no JAX module loaded;
* every public name of those three JAX modules exists in the port's.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import ops as jax_ops
from hslu_i.ba_raytracing.f2501_raytracer_tpu import utils as jax_utils
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops import vecmath as jax_vecmath
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import ops, utils
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import vecmath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBMODULES = ("camera", "colorops", "intersect", "sampling", "shading", "trace", "vecmath")


def _public(module):
    """The public names a module's own source binds at its top level (not
    the submodules that other imports add to a package later)."""
    tree = ast.parse(open(module.__file__).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
    return {k for k in names if not k.startswith("_")}


@pytest.mark.parametrize("jax_module, module", [
    (jax_utils, utils), (jax_ops, ops), (jax_vecmath, vecmath)], ids=["utils", "ops", "vecmath"])
def test_the_port_exposes_every_name_of_the_jax_module(jax_module, module):
    names = _public(jax_module)
    assert names and not names - _public(module), names - _public(module)
    assert all(hasattr(module, k) for k in names)


def _vectors(seed, n=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("name", ["cross", "mag", "lerp"])
def test_vecmath_functions_match_jax(name):
    a, b, t = _vectors(5)
    t = np.abs(t[:, :1])
    args = {"cross": (a, b), "mag": (a,), "lerp": (a, b, t)}[name]
    got = getattr(vecmath, name)(*map(torch.from_numpy, args)).numpy()
    ref = np.asarray(getattr(jax_vecmath, name)(*map(jnp.asarray, args)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_ray_matches_jax():
    o, d, t = _vectors(6)
    ior = np.random.default_rng(7).uniform(1.0, 1.5, 7).astype(np.float32)
    t = t[:, 0]
    mask = np.arange(7) % 3 != 0
    for valid in (None, mask):
        ray = vecmath.Ray.new(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(ior),
                              None if valid is None else torch.from_numpy(valid))
        ref = jax_vecmath.Ray.new(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ior),
                                  None if valid is None else jnp.asarray(valid))
        np.testing.assert_allclose(ray.direction.numpy(), np.asarray(ref.direction), rtol=1e-6)
        np.testing.assert_array_equal(ray.origin.numpy(), np.asarray(ref.origin))
        np.testing.assert_array_equal(ray.refraction_index.numpy(),
                                      np.asarray(ref.refraction_index))
        assert ray.valid_mask.dtype == torch.bool
        np.testing.assert_array_equal(ray.valid_mask.numpy(), np.asarray(ref.valid_mask))
        np.testing.assert_allclose(ray.at(torch.from_numpy(t)).numpy(),
                                   np.asarray(ref.at(jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    assert vecmath.Ray.invalid_value() == jax_vecmath.Ray.invalid_value() == float("inf")
    with pytest.raises(Exception):  # frozen, as the JAX record
        ray.origin = ray.direction


def test_timing_names_match_jax():
    ours, ref = utils.TileStats(), jax_utils.TileStats()
    assert ours.summary() == ref.summary() == {}
    for s in np.random.default_rng(8).uniform(0.01, 0.5, 9).tolist():
        ours.push(s)
        ref.push(s)
    assert ours.summary() == ref.summary()
    timing, jax_timing = utils.RenderTiming(), jax_utils.RenderTiming()
    assert timing.next().iteration == jax_timing.next().iteration == 1
    assert timing.elapsed >= timing.delta >= 0.0


def test_ops_imports_its_submodules_without_a_cycle():
    """In a fresh process, `ops` first: its seven submodules are attributes,
    `ops.kernels` then imports, and no JAX module is loaded."""
    code = (
        "import sys\n"
        "import hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops as o\n"
        f"mods = [getattr(o, n) for n in {SUBMODULES!r}]\n"
        "o.trace.trace_rays\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels\n"
        "from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import TileStats\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(mods), kernels.LIGHT_LANES_MIN_LIGHTS)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["7", "16"], out.stderr
