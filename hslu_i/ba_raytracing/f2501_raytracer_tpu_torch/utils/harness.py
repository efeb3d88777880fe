"""Helpers that chip_smoke.py, utils/ab.py and the card tests share: the
block partitions that the warp kernels must take, the light counts of the
feature configs, the 235-block cloud, the two-cluster stack scene and its
inputs, a tile of a frame as one call, the calls of a kernel wrapper caught
from a render, the shadow rays of the light loop, bitwise checks of the
node kernels, the card's peaks and the occlusion's bound, timing by CUDA
events and by torch.profiler, and small frames through the CPU twins in a
process of their own (`python -m ...utils.harness JOBS THREADS`,
`twin_frames`).

utils/ab.py imports this file from its own directory (as `harness`), so
that it can measure through it the package of another checkout, one that
may lack this file.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.config import RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.materials import (
    Material,
    TransmissionProperties,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import triangle_cloud
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, shading, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import (
    _backface_mask,
    _dot3_planes,
    _homogeneous,
    _tri_block_ts,
    occlude_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import (
    RaytracerRenderer,
    plan_frame,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene, TriangleData
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.lighting import PointLight

# Block partitions that the JAX package takes (pallas_kernels.py:149-160)
# and that the kernels with a warp per ray take too
PARTITIONS = {
    # more than 32 Morton blocks in one superblock: rounds of 32 lanes
    "superblock64": dict(triangle_block=32, superblock=64),
    # blocks of 48 rows: a ragged last round of rows
    "block48": dict(triangle_block=48),
}


# the light counts of the feature configs: default, soft_shadows,
# high_quality (reference_default's) and extreme_quality
LIGHT_FEATURES = {5: {}, 50: dict(soft_shadows=True), 95: dict(high_quality=True),
                  140: dict(extreme_quality=True)}


def cloud_scene(n_lights, device="cuda"):
    """(config, device scene) of the 235-block cloud, whose lit shadow scans
    cross many opaque Morton blocks: semesterbild plus 15,000 small
    triangles (triangle_cloud.build_scene's other defaults; a tenth of them
    glass) in blocks of 64, as at 1080p, `realistic` with the light cloud
    of the feature config that has n_lights lights (LIGHT_FEATURES)."""
    c = RenderConfig(width=1920, height=1080, scene_backface_culling=True, triangle_block=64,
                     weight_cutoff=1e-3, reflections=True, light_reflections=True,
                     refractions=True, **LIGHT_FEATURES[n_lights])
    scene = RaytracerRenderer(c, device=device).device_scene(
        triangle_cloud.build_scene(c, n=15000))
    assert scene.n_lights == n_lights and not scene.streaming, scene.n_lights
    return c, scene


def stack_scene() -> Scene:
    """The two-cluster stack scene of the JAX package's shadow-scan tests
    (tests/test_prime_gate.py::_cloud_scene), built with the port's Scene
    from the same seeds: two Morton clusters on one shadow column, a
    watertight opaque grid at y = 0.45 over x [0.2, 0.3] and 24 small
    triangles at y ~ 0.6 (tests/test_opq_gate.py::_lanegate_scene), lit by
    a 17-light cloud around (0.25, 0.9, 0.5): three chunks of 8 lights."""
    s = Scene()
    opaque = Material.new((0.7, 0.7, 0.7), 0.0, 0.0, TransmissionProperties.none())
    xs, zs = np.linspace(0.2, 0.3, 13), np.linspace(0.44, 0.56, 9)
    for i in range(12):
        for k in range(8):
            a, bx = (xs[i], 0.45, zs[k]), (xs[i + 1], 0.45, zs[k])
            cz, d2 = (xs[i], 0.45, zs[k + 1]), (xs[i + 1], 0.45, zs[k + 1])
            s.add_triangle(TriangleData.with_material(a, bx, cz, opaque))
            s.add_triangle(TriangleData.with_material(d2, cz, bx, opaque))
    rng = np.random.default_rng(11)
    for _ in range(24):
        cx, cy = rng.uniform(0.21, 0.29), rng.uniform(0.58, 0.62)
        e1, e2 = rng.uniform(-0.008, 0.008, 3), rng.uniform(-0.008, 0.008, 3)
        a = np.array([cx, cy, 0.5])
        s.add_triangle(TriangleData.with_material(
            tuple(a), tuple(a + e1), tuple(a + e2),
            Material.new((0.4, 0.5, 0.6), 0.0, 0.2, TransmissionProperties.none())))
    rng = np.random.default_rng(23)
    for _ in range(17):
        p = np.float32([0.25, 0.9, 0.5]) + rng.uniform(-0.02, 0.02, 3)
        s.add_light(PointLight.new(tuple(p), (1.0, 0.9, 0.8), 0.3))
    return s


def stack_inputs(n=256, device="cuda"):
    """(config, device scene, light inputs) of `stack_scene` as the JAX
    tests light it: n surface points along x in [0, 1] at y = 0.1, z = 0.5,
    normal +y, view +z, colour (0.8, 0.7, 0.6), shininess 0.3, all valid;
    the light inputs are the 11 leading arguments of the shading kernels."""
    c = RenderConfig(width=32, height=16, triangle_block=64)
    scene = RaytracerRenderer(c, device=device).device_scene(stack_scene())
    x = torch.linspace(0.0, 1.0, n, device=device)

    def rows(v):
        return torch.tensor(v, dtype=torch.float32, device=device).expand(n, 3).contiguous()

    point = torch.stack([x, torch.full_like(x, 0.1), torch.full_like(x, 0.5)], -1)
    light = (scene.light_pack, scene.sph_pack, scene.trb_pack, scene.tri_blk_pack,
             scene.tri_blk_aabb, point, rows([0.0, 1.0, 0.0]), rows([0.0, 0.0, 1.0]),
             rows([0.8, 0.7, 0.6]), torch.full_like(x, 0.3), torch.ones_like(x))
    return c, scene, light


def node_state(n, seed, device="cuda"):
    """The node kernels' per-ray state after the light inputs, drawn from a
    seed for n rays: t, w, rior, budget, from_refl, h_httr, h_met, h_ior,
    h_opac, h_boost (as trace._node_args orders them)."""
    rng = np.random.default_rng(seed)

    def g(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (g(rng.uniform(0.1, 2.0, n).astype(np.float32)),
            g(rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)),
            g(np.where(rng.random(n) < 0.7, trace.AIR, 1.5).astype(np.float32)),
            g(rng.integers(-1, 9, n).astype(np.int32)),
            g((rng.random(n) < 0.5).astype(np.float32)),
            g((rng.random(n) < 0.3).astype(np.float32)),
            g(rng.uniform(0.0, 0.5, n).astype(np.float32)),
            g(rng.uniform(1.2, 1.8, n).astype(np.float32)),
            g(rng.uniform(0.2, 1.0, n).astype(np.float32)),
            g(rng.uniform(0.0, 0.5, n).astype(np.float32)))


# published H100 SXM peaks: fp32 outside the tensor cores, HBM bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations of one shadow pair test (rt_occlude.cuh::occl_tri: the Woop
# test and the normal's cosine; the Fresnel of a transmissive hit is rare)
OPS_OCCL = 46


def bound_ms(byts, ops):
    """(the least time the card could take, "bytes" or "operations")"""
    by, op = byts / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(by, op), ("bytes" if by >= op else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def gate_hits(boxes, o, d, t_limit):
    """(N, n_boxes) bool: does the segment [0, t_limit] cross each box (the
    kernels' widened slab test, rt_common.cuh::rt_gate)?"""
    inv = 1.0 / d
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    m = 1e-5 * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    t1 = (lo - m - o[:, None, :]) * inv[:, None, :]
    t2 = (hi + m - o[:, None, :]) * inv[:, None, :]
    nan = torch.isnan(t1) | torch.isnan(t2)
    a = torch.where(nan, -float("inf"), torch.minimum(t1, t2)).amax(-1)
    b = torch.where(nan, float("inf"), torch.maximum(t1, t2)).amin(-1)
    return (b >= a.clamp(min=0)) & (a <= t_limit[:, None])


def crossed_blocks(boxes, o, d, t_limit, chunk=8192):
    """How many (ray, block) pairs there are whose segment [0, t_limit]
    crosses the block's box (in chunks of rays: the pair matrix of 655,360
    rays and 3125 blocks does not fit)."""
    return sum(int(gate_hits(boxes, o[s0:s0 + chunk], d[s0:s0 + chunk],
                             t_limit[s0:s0 + chunk]).sum())
               for s0 in range(0, o.shape[0], chunk))


def occlusion_tests(scene, o, d, md, opq, real, big_rows=0, crossed=None):
    """The shadow pair tests this data needs, as the bound counts them: for
    a real ray that reaches its light, the `big_rows` big rows and the rows
    of every block its segment crosses (`crossed` such (ray, block) pairs,
    counted here if None); for an occluded one, one. Returns (tests, live
    rays, occluded rays, crossed)."""
    live = ~opq & real & (md > 0)
    n_live = int(live.sum())
    n_opq = int((opq & real).sum())
    if crossed is None:
        crossed = crossed_blocks(scene.tri_aabb, o[live], d[live], md[live])
    return scene.tri_block * crossed + big_rows * n_live + n_opq, n_live, n_opq, crossed


def scan_lengths(scene, o, d, md, backface, chunk=1 << 17):
    """Per ray, the pair tests of the resident occlusion's one-thread scan
    (occlude_triangles.cu's ray per lane): every big row, then the rows of
    each block that passes its superblock's and its own gate, in storage
    order, each pack up to its first opaque hit, none after one. (R,) int64."""
    starts = np.concatenate([[0], np.cumsum(scene.sb_sizes)]).tolist()
    out = []
    for s0 in range(0, o.shape[0], chunk):
        oc, dc, mc = o[s0:s0 + chunk], d[s0:s0 + chunk], md[s0:s0 + chunk]
        o4 = _homogeneous(oc)

        def pack_tests(pack, scan):
            t, valid = _tri_block_ts(pack[:, 0:12].T, pack[:, 12], pack[:, 13], o4, dc)
            httr = pack[None, :, 14] != 0.0
            if backface:
                valid = valid & _backface_mask(_dot3_planes(dc, pack[:, 15:18].T), httr)
            stop = valid & (t <= mc[:, None]) & ~httr
            hit = stop.any(1)
            rows = torch.where(hit, stop.int().argmax(1) + 1, pack.shape[0])
            return torch.where(scan, rows, 0), scan & hit

        done = ~(mc > 0)
        n, opq = pack_tests(scene.trb_pack, ~done)
        done = done | opq
        sb_hit = gate_hits(scene.tri_saabb, oc, dc, mc)
        blk_hit = gate_hits(scene.tri_aabb, oc, dc, mc)
        for g, (b0, b1) in enumerate(zip(starts[:-1], starts[1:])):
            for b in range(b0, b1):
                scan = ~done & blk_hit[:, b] & (sb_hit[:, g] | (b1 - b0 == 1))
                tests, opq = pack_tests(scene.tri_cast_pack[b], scan)
                n, done = n + tests, done | opq
        out.append(n)
    return torch.cat(out)


def shadow_rays(scene, c, o, d, active):
    """What a node sends to the occlusion kernels for these rays: the
    (origin, direction, max distance, real) of every light chunk, taken from
    the port's own light loop (`C = min(L, 2^21 // R)` lights a chunk);
    `real` marks the rays of lanes that hit something (light-major, as the
    rays are)."""
    hit, hval, point, d = trace._cast_active(scene, c, o, d, active)
    sent = []

    def occlude(so, sd, md):
        sent.append((so, sd, md, hval.repeat(so.shape[0] // hval.shape[0])))
        return occlude_rays(scene, so, sd, md, c.backface_culling)

    shading._light_loop(scene.light_pack, scene.n_lights, occlude, point, hit.normal, d,
                        hit.color, hit.shininess, hval, float(c.camera.epsilon_distance))
    return sent


def same_bits(a, b):
    """Equal bit for bit, NaN included (the child fields of a ray without a
    hit may be NaN in the kernels and their twins alike)."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def same_occlusion(x, y):
    """Two occlusion results (dec, opq, fsub) with `opq` identical and,
    where it is false, the sums' bits identical (the sums of an occluded
    ray are not specified)."""
    free = ~x[1]
    return (torch.equal(x[1], y[1]) and same_bits(x[0][free], y[0][free])
            and same_bits(x[2][free], y[2][free]))


def flat(out):
    """A kernel's outputs as a flat list of tensors (dicts of fields opened)."""
    items = []
    for x in out:
        items += list(x.values()) if isinstance(x, dict) else [x]
    return items


def assert_node_bits(rows_out, fields_out, label=""):
    """shade_eval_rows and shade_eval on the same inputs: contrib, every
    child field and the masks bit for bit, rays without a hit included."""
    contrib, rfl, rfl_m, rfr, rfr_m = rows_out
    f_contrib, f_rfl, f_rfr = fields_out
    label = f"{label} ({contrib.shape[0]} rays)"
    assert same_bits(contrib, f_contrib), f"{label}: contrib bits"
    for rows, m, f in ((rfl, rfl_m, f_rfl), (rfr, rfr_m, f_rfr)):
        assert torch.equal(m, f["mask"]), f"{label}: masks"
        assert same_bits(rows[:, 0:9], torch.cat([f["o"], f["d"], f["w"]], 1)), label
        assert same_bits(rows[:, 10], f["budget"].float()), label
    assert same_bits(rfr[:, 9], f_rfr["ior"]), label


def tile_call(scene, c, k, device="cuda", aa=False):
    """A call that renders tile k of the frame of config c on `scene`: one
    sample per pixel, or with `aa` the frame's AA samples (the plan's U
    offsets and weights, pix_per_tile * U rays)."""
    plan = plan_frame(c)
    n = plan.pix_per_tile
    order = np.full((n,), -1, np.int64)  # -1: a padding slot past the frame
    part = plan.order[k * n: (k + 1) * n]
    order[:part.shape[0]] = part
    order = torch.from_numpy(order).to(device)
    if aa:
        offsets = torch.from_numpy(np.ascontiguousarray(plan.offsets, np.float32)).to(device)
        weights = torch.from_numpy(np.ascontiguousarray(plan.weights, np.float32)).to(device)
    else:
        offsets, weights = torch.zeros((1, 3), device=device), torch.ones(1, device=device)
    per_tile = trace.make_raygen_per_tile(scene, c, offsets, weights, n)
    return lambda: per_tile(order)


def caught_calls(names, run, limit=None):
    """{name: the first `limit` (None: all) calls of kernels.<name> while
    `run` runs, as (args, kw)}, tensor arguments copied (the pool and the
    stack reuse their buffers). A pool chunk captured as a CUDA graph makes
    the catching wrappers' calls between its graphs (ops/trace.py's
    `_Captured`), so every call is caught."""
    wrappers = {name: getattr(kernels, name) for name in names}
    caught = {name: [] for name in names}

    def catching(name):
        def catch(*a, **kw):
            if limit is None or len(caught[name]) < limit:
                caught[name].append(([x.clone() if isinstance(x, torch.Tensor) else x
                                      for x in a], kw))
            return wrappers[name](*a, **kw)
        return catch

    for name in names:
        setattr(kernels, name, catching(name))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, wrapper in wrappers.items():
            setattr(kernels, name, wrapper)
    return caught


def cuda_ms(fn, iters, warmup=3):
    """The mean time of fn() by CUDA events: the wrapper's host work and its
    kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters, per_call=1):
    """Device time of one call's CUDA kernels written in this repository,
    all of them (torch.profiler; the mean over `iters` calls): what CUDA
    events cannot show for a kernel shorter than its wrapper's time on the
    host. `per_call`: the launches of one call (None: any whole number).
    None if no trace of three caught the launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a trace may miss launches, now and then all of them
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages() if "anonymous namespace" in e.key]
        n = sum(e.count for e in ours)
        total = sum(e.self_device_time_total for e in ours) / 1e3
        if per_call is None:
            if n and n % iters == 0:
                return total / iters
            continue
        assert n <= iters * per_call, [(e.key, e.count) for e in ours]
        if n == iters * per_call or (n and per_call == 1):
            return total / n * per_call
    return None


def twin_frames(jobs_path: str) -> None:
    """Render each (label, config, host scene) of the pickled list at
    `jobs_path`, in order, through the CPU twins, and write `<label>.npz`
    beside it as each is done: the u32 frame, `last_dropped`, whether the
    scene streams, and the seconds it took with the scene's set-up.
    chip_smoke.py runs this in a process of its own while the card renders,
    and reads each file when it needs it."""
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    out_dir = os.path.dirname(jobs_path)
    for label, c, host in jobs:
        t0 = time.monotonic()
        r = RaytracerRenderer(c, device="cpu")
        scene = r.device_scene(host)
        frame = r.render_u32(scene)
        tmp = os.path.join(out_dir, f"{label}.part.npz")
        np.savez(tmp, frame=frame, dropped=r.last_dropped, streaming=scene.streaming,
                 seconds=time.monotonic() - t0)
        os.replace(tmp, os.path.join(out_dir, f"{label}.npz"))  # whole or absent


if __name__ == "__main__":
    torch.set_num_threads(int(sys.argv[2]))
    twin_frames(sys.argv[1])
