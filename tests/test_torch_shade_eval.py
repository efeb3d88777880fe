"""PyTorch port: `shade_eval` (CPU, through its plain twin) against the JAX
`pallas_shade_eval` kernel in interpret mode, on the hit fields and node
state of tests/test_torch_shade_rows.py (the JAX cast of camera rays plus
seeded random rays; seeded weights, media, budgets and flags).

Bar: identical child masks; identical budgets of spawned children; contrib
and the o, d, w (and refraction ior) of spawned children within rtol 2e-5,
atol 2e-6 (the traced-colour bar, tests/test_pallas_kernels.py:83-84). A
disabled child type is all zeros and False (refraction ior 1) in both.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.pallas_kernels import pallas_shade_eval
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from test_torch_shade_rows import ORDER, _static, setup  # noqa: F401  (fixture)

FIELDS = ORDER[:-1]  # no pixel index


@pytest.mark.parametrize("children", [
    dict(backface=False),
    dict(backface=True, refractions=False),
], ids=["both", "reflection-backface"])
def test_shade_eval_twin_matches_pallas(setup, children):
    cfg, jds, tds, fields = setup
    kw = dict(children)
    static = _static(cfg, jds, kw.pop("backface"), **kw)
    contrib, refl, refr = pallas_shade_eval(
        jds.light_pack, jds.sph_pack, jds.trb_pack, jds.tri_blk_pack, jds.tri_blk_aabb,
        *[jnp.asarray(fields[k]) for k in FIELDS], ray_tile=128, interpret=True, **static,
    )
    kernels.reset_launch_counts()
    g_contrib, g_refl, g_refr = kernels.shade_eval(
        tds.light_pack, tds.sph_pack, tds.trb_pack, tds.tri_blk_pack, tds.tri_blk_aabb,
        *[torch.from_numpy(fields[k]) for k in FIELDS], **static,
    )
    assert kernels.LAUNCHES["shade_eval"] == 0  # CPU tensors: the twin
    np.testing.assert_allclose(g_contrib.numpy(), np.asarray(contrib), rtol=2e-5, atol=2e-6)
    assert np.abs(np.asarray(contrib)).max() > 0
    for got, ref, on in ((g_refl, refl, static["reflections"]),
                         (g_refr, refr, static["refractions"])):
        assert sorted(got) == sorted(ref)
        m = np.asarray(ref["mask"])
        np.testing.assert_array_equal(got["mask"].numpy(), m)
        if not on:
            assert not m.any()
            for k in ref:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
            continue
        assert m.any()
        np.testing.assert_array_equal(got["budget"].numpy()[m], np.asarray(ref["budget"])[m])
        for k in set(ref) - {"mask", "budget"}:
            np.testing.assert_allclose(got[k].numpy()[m], np.asarray(ref[k])[m],
                                       rtol=2e-5, atol=2e-6, err_msg=k)
