"""Render the test-box scene (ref examples/test_scene.rs): semesterbild.py with
`--scene test_scene`, its other flags as given."""

from __future__ import annotations

import os
import sys

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4)))

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.examples.semesterbild import (  # noqa: E402
    main,
)

if __name__ == "__main__":
    main(sys.argv[1:] + ["--scene", "test_scene"])
