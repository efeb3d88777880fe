"""PyTorch port: the three shading wrappers against the JAX kernels on the
cloud of tests/test_torch_shadow_scan.py (semesterbild plus 3,000 small
triangles in 49 blocks of 64, 27 of them opaque) under 50, 95 and 140
lights: the storage-order walk and its first-opaque-hit exit."""

from __future__ import annotations

from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_shadow_scan import check_wrappers, points, scene  # noqa: F401 (fixture)


@points(("cloud50", False), ("cloud95", False), ("cloud140", False))
def test_wrappers_match_jax(scene, kernel, backface):
    check_wrappers(scene, kernel, backface)
