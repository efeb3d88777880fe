"""PyTorch port: `light_shade` against the JAX `pallas_light_shade` kernel
(interpret mode) with the soft-shadow light cloud: semesterbild's 5 lights
become 50, packed into 56 rows. The TPU kernel runs six full 8-light chunks
plus a tail and disables the 6 padding rows; the port loops over the 50
lights. Inputs, bar and knife edges as tests/test_torch_light_shade.py.
"""

from __future__ import annotations

import pytest

from test_torch_light_shade import check_light_shade, make_setup


@pytest.mark.parametrize("scene_name", ["mixed", "semesterbild"])
def test_light_shade_soft_shadows_match_pallas(scene_name):
    check_light_shade(make_setup(scene_name, soft=True), backface=False)
