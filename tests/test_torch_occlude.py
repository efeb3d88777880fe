"""PyTorch port: the scene-level `occlude_rays` (CPU, through the plain twins
of the `occlude_triangles` and `occlude_triangles_stream` kernels) against
the JAX `occlude_rays` through `pallas_occlude_triangles` and
`pallas_occlude_triangles_stream` in interpret mode.

Scenes: tests/scenes.py `mixed_scene` (spheres, big primitives,
transmission), semesterbild at triangle_block=32 (Morton blocks under a
superblock) and the two-cluster scene of tests/test_streaming.py:103-137,
whose Morton blocks mix transmissive and opaque, so the per-block Fresnel
table takes both values. Built once by the JAX package and carried across
as numpy; the streamed view is `dataclasses.replace(ds, streaming=True)`.

Bar (tests/test_pallas_kernels.py:59-61): `completely_occluded` identical;
`combined_opacity` and `color_filter` within atol 1e-5 where it is False
(they are unspecified for an occluded ray: the TPU kernel skips a block once
every ray of its tile is occluded, the port's kernels stop a ray's scan at
its first opaque hit, and the lighting reads them only for a light that
reaches the point). Knife edges are set apart, at most 0.5% of the rays:
rays whose float32 result misses the float64 evaluation of the same formulas
(near-tangent passes of a transmissive sphere, ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu import RenderConfig as JaxConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu import build_device_scene as jax_build
from hslu_i.ba_raytracing.f2501_raytracer_tpu.models import build as jax_model
from hslu_i.ba_raytracing.f2501_raytracer_tpu.ops.intersect import (
    occlude_rays as jax_occlude_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import (
    _occlusion_result,
    _sphere_occlusion,
    occlude_packs,
    occlude_rays,
)
from scenes import mixed_scene
from test_streaming import _clustered_mixed_blocks_scene
from test_torch_cast import carry
from test_torch_cast_stream import stream_rays

ATOL = 1e-5


def _build(name):
    cfg = JaxConfig(width=16, height=8, triangle_block=32)
    scene = {"mixed": mixed_scene, "clustered": _clustered_mixed_blocks_scene}.get(name)
    ds = jax_build(scene(cfg) if scene else jax_model("semesterbild", cfg), cfg)
    return cfg, ds


@pytest.fixture(scope="module", params=["clustered", "mixed", "semesterbild"])
def setup(request):
    cfg, jds = _build(request.param)
    if request.param == "clustered":
        assert len(set(jds.block_has_trans)) == 2, jds.block_has_trans
    o, d = stream_rays(cfg, 128, seed=5)
    rng = np.random.default_rng(6)
    md = rng.uniform(0.05, 3.0, o.shape[0]).astype(np.float32)
    md[::17] = 0.0  # parked lanes / lights behind the surface
    md[5::31] = -1.0
    return jds, carry(jds), o, d, md


def _f64_reference(tds, o, d, md, backface):
    """The same formulas in float64: spheres, big primitives, Morton blocks."""
    dd = lambda t: t.double()  # noqa: E731
    dec, opq, fsub = _sphere_occlusion(dd(tds.sph_pack), dd(o), dd(d), dd(md), backface)
    tdec, topq, tfsub = kernels.occlude_triangles_plain(
        dd(tds.trb_pack), dd(tds.tri_cast_pack), dd(o), dd(d), dd(md), backface)
    return _occlusion_result(dec + tdec, opq | topq, fsub + tfsub)


def _knife_edges(got, ref64):
    bad = got[0] != ref64[0]
    bad |= ~torch.isclose(got[1].double(), ref64[1], rtol=0, atol=ATOL)
    bad |= ~torch.isclose(got[2].double(), ref64[2], rtol=0, atol=ATOL).all(dim=1)
    return bad.numpy()


@pytest.mark.parametrize("backface", [False, True])
@pytest.mark.parametrize("streaming", [False, True], ids=["resident", "streamed"])
def test_occlude_rays_matches_jax(setup, streaming, backface):
    jds, tds, o, d, md = setup
    jds = dataclasses.replace(jds, streaming=streaming)
    tds = dataclasses.replace(tds, streaming=streaming)
    ref = jax_occlude_rays(jds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(md), backface,
                           use_pallas=True, interpret=True, ray_tile=128)
    t = torch.from_numpy
    kernels.reset_launch_counts()
    got = occlude_rays(tds, t(o), t(d), t(md), backface)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU tensors: the twins
    edge = _knife_edges(got, _f64_reference(tds, t(o), t(d), t(md), backface))
    assert edge.sum() <= 0.005 * edge.size, np.where(edge)
    opq = np.asarray(ref[0])
    np.testing.assert_array_equal(got[0].numpy()[~edge], opq[~edge])
    free = ~opq & ~edge
    np.testing.assert_allclose(got[1].numpy()[free], np.asarray(ref[1])[free], atol=ATOL)
    np.testing.assert_allclose(got[2].numpy()[free], np.asarray(ref[2])[free], atol=ATOL)
    # occluded and unoccluded rays, partial opacity, and rays that cannot hit
    assert opq.any() and free.any() and not opq[md <= 0].any()
    assert (np.asarray(ref[1])[md <= 0] == 1.0).all()
    if any(jds.block_has_trans) or jds.bigtri_trans:
        part = np.asarray(ref[1])[free]
        assert ((part > 0) & (part < 1)).any()


def test_streamed_resident_and_pack_occlusion_agree(setup):
    """Inside the port: streamed and resident `occlude_rays` add the same
    partial sums in the same order (identical bits), and `occlude_packs`
    (the light kernels' scan order over `tri_blk_pack`) agrees to atol."""
    _, tds, o, d, md = setup
    t = torch.from_numpy
    a = occlude_rays(dataclasses.replace(tds, streaming=False), t(o), t(d), t(md), True)
    b = occlude_rays(dataclasses.replace(tds, streaming=True), t(o), t(d), t(md), True)
    c = occlude_packs(tds.sph_pack, tds.trb_pack, tds.tri_blk_pack, t(o), t(d), t(md), True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], c[0])
    for x, y in ((a[1], b[1]), (a[2], b[2])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
    for x, y in ((a[1], c[1]), (a[2], c[2])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL)


def test_occlusion_wrappers_check_inputs(setup):
    _, tds, o, d, md = setup
    o, d, md = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(md)
    res = (tds.trb_pack, tds.tri_cast_pack, tds.tri_aabb, tds.tri_saabb)
    kw = dict(bigtri_trans=tds.bigtri_trans, block_has_trans=tds.block_has_trans,
              sb_sizes=tds.sb_sizes)
    dec, opq, fsub = kernels.occlude_triangles(*res, o, d, md, **kw)
    assert dec.dtype == torch.float32 and opq.dtype == torch.bool
    assert dec.shape == opq.shape == (o.shape[0],) and fsub.shape == (o.shape[0], 3)
    with pytest.raises(TypeError):
        kernels.occlude_triangles(*res, o, d, md.double(), **kw)
    with pytest.raises(ValueError):
        kernels.occlude_triangles(*res, o, d, md[:-1], **kw)
    with pytest.raises(ValueError):
        kernels.occlude_triangles(tds.trb_pack[:, :16], *res[1:], o, d, md, **kw)
    strm = (tds.tri_cast_pack, tds.tri_aabb, tds.tri_saabb)
    skw = dict(block_has_trans=tds.block_has_trans, sb_sizes=tds.sb_sizes)
    dec, opq, fsub = kernels.occlude_triangles_stream(*strm, o, d, md, **skw)
    assert dec.dtype == torch.float32 and opq.dtype == torch.bool and fsub.shape == (o.shape[0], 3)
    with pytest.raises(TypeError):
        kernels.occlude_triangles_stream(*strm, o.double(), d, md, **skw)
    with pytest.raises(ValueError):
        kernels.occlude_triangles_stream(tds.tri_cast_pack, tds.tri_aabb[:, :6], tds.tri_saabb,
                                         o, d, md, **skw)
    # the superboxes: one row per entry of sb_sizes, which must cover the blocks
    nb = tds.triangle_blocks
    with pytest.raises(ValueError):
        kernels.occlude_triangles_stream(*strm[:2], tds.tri_saabb[:, :6], o, d, md, **skw)
    with pytest.raises(ValueError, match="do not cover"):
        kernels.occlude_triangles_stream(*strm, o, d, md, block_has_trans=tds.block_has_trans,
                                         sb_sizes=(nb + 1,) + tds.sb_sizes[1:])
    with pytest.raises(TypeError):  # the partition is required
        kernels.occlude_triangles_stream(*strm, o, d, md)
    # on the CPU route, blocks of any row count
    narrow = kernels.occlude_triangles_stream(tds.tri_cast_pack[:, :24].contiguous(), *strm[1:],
                                              o, d, md, **skw)
    assert narrow[1].shape == (o.shape[0],)
    # the per-block transmissive table: one entry per block, all ones when empty
    nb = tds.triangle_blocks
    table = kernels._block_httr(tds.block_has_trans, nb, torch.device("cpu"))
    assert table.tolist() == [float(f) for f in tds.block_has_trans]
    assert kernels._block_httr((), nb, torch.device("cpu")).tolist() == [1.0] * nb
    assert kernels._block_httr(tds.block_has_trans, nb, torch.device("cpu")) is table
    with pytest.raises(ValueError):
        kernels._block_httr((True,) * (nb + 1), nb, torch.device("cpu"))
    assert sum(kernels.LAUNCHES.values()) == 0
