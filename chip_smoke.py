"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases (any failure fails the run; nothing is caught; each prints its
seconds):
  1. the card's name and power limit; build all four CUDA kernels from
     hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/csrc (one nvcc each, in
     parallel) and print the build time and ptxas resource lines;
  2. hold each kernel against its plain PyTorch twin on the card at its
     path's shapes, taken from real semesterbild tiles, and time both with
     CUDA events: cast_triangles and shade_eval_rows at R = 131072 (the
     prologue of a 1080p `realistic` tile) and W = 2048 (one pool
     iteration); light_shade at R = 131072 from a 1080p tile with 5 lights
     (`default`) and 50 lights (`soft_shadows`); shade_eval at R = 131072
     (the first wavefront of a 960x540 stack-path tile). Then the pool's
     chunk commit three times on the same rows: identical bits;
  3. render the full 1920x1080 `realistic` frame (bench.py's settings, the
     packed-row pool path) through RaytracerRenderer(cfg, device="cuda"):
     warm frame wall time, launch counts (cast_triangles and
     shade_eval_rows > 0, the others 0), dropped rays (0), the u32
     checksum, and a second warm frame with the same checksum; then the
     frame with the atomic commit (`index_add_`) against the sorted
     commit, in turns old, new, new, old; then one tile traced with
     torch.profiler: wall, pool iterations, device busy time and the
     kernels that take it;
  4. the other paths at their sizes: 1080p `default`, `anti_aliasing` and
     `soft_shadows` (light_shade > 0, shade_eval_rows == 0), the 960x540
     stack-path frame (compaction_ratio 1; shade_eval > 0, shade_eval_rows
     == 0) and a 240x135 `packed_stage=False` frame (shade_eval > 0): warm
     wall, launches, dropped, valid share, u32 checksum;
  5. small frames of every path on the card and through the CPU twins in
     this process: < 0.5% of pixels may differ by more than 2e-3 in linear
     colour, and `valid` may differ only at knife edges (< 0.5%);
  6. print the {"kernels": [...]} line, then the {"ok": true, ...} line.
With --report, the measurements also go to PATH as JSON.

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--report", help="also write the measurements to this JSON file")
ARGS = parser.parse_args()

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(2)

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (  # noqa: E402
    RaytracerRenderer,
    RenderConfig,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import (  # noqa: E402
    _homogeneous,
    _sphere_ts,
    _tri_block_ts,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import plan_frame  # noqa: E402

PKG = "hslu_i/ba_raytracing/f2501_raytracer_tpu_torch"
TPU_KERNELS = "hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py"
# published H100 SXM peaks: fp32 outside the tensor cores, HBM bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations (mul, add, div, sqrt) per test, counted from the sources:
# Woop triangle test (rt_tri_test), sphere shadow test incl. its normal,
# per-(ray, light) setup, per-ray shading epilogue with both children
# (rt_node.cuh) and without (light_shade.cu: the stores)
OPS_TRI, OPS_SPHERE, OPS_LIGHT, OPS_EPILOGUE, OPS_LIGHT_EPILOGUE = 40, 48, 60, 200, 6

# bench.py:222-290 settings; feature sets bench.py:37-42
MAIN = dict(
    scene_backface_culling=True, tile_rays=131072, max_nodes=48,
    weight_cutoff=1e-3, compaction_ratio=64, kernel_ray_tile=512, loop_chunk=96,
    device_encode=True, stage_mode="scatter", commit_splits=1,
)
REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)
LIGHTING = {
    "default": dict(),
    "anti_aliasing": dict(anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True),
    "soft_shadows": dict(soft_shadows=True),
}
DEV = torch.device("cuda")
report = {"phase_s": {}}


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.monotonic()
    yield
    s = time.monotonic() - t0
    report["phase_s"][name] = s
    log(f"[phase {name}: {s:.1f} s]")


def cuda_ms(fn, iters, warmup=3):
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


def max_err(a, b):
    a, b = a.float(), b.float()
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin), "non-finite values differ"
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def checksum(fb):
    return hashlib.sha256(fb.tobytes()).hexdigest()[:16]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(byts, ops):
    by, op = byts / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(by, op), ("bytes" if by >= op else "operations")


# ---- phase 1: card and build -------------------------------------------
with phase("build"):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    report["card"] = smi
    t0 = time.monotonic()
    built = kernels.build_kernels()
    report["build_s"] = time.monotonic() - t0
    log(f"kernel build: {report['build_s']:.1f} s (parallel nvcc, {len(built)} kernels)")
    assert sorted(built) == sorted(kernels.KERNEL_SOURCES), built
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

# ---- scenes and tiles -----------------------------------------------------
cfg = RenderConfig(width=1920, height=1080, **MAIN, **REALISTIC)
renderer = RaytracerRenderer(cfg, device="cuda")
ds = renderer.device_scene(build("semesterbild", cfg))
eps = float(cfg.camera.epsilon_distance)
plan = plan_frame(cfg)
R = plan.pix_per_tile * plan.aa
W = max((R // cfg.compaction_ratio) // cfg.kernel_ray_tile * cfg.kernel_ray_tile,
        cfg.kernel_ray_tile)
assert (R, W) == (131072, 2048), (R, W)


def tile_rays(c, k):
    """Primary rays of tile k of config c's frame (one sample per pixel)."""
    p = plan_frame(c)
    n = p.pix_per_tile
    idx = torch.from_numpy(p.order[k * n: (k + 1) * n]).to(DEV)
    cam = c.camera
    px = (idx % c.width).float() * cam.w2s_width
    py = torch.div(idx, c.width, rounding_mode="floor").float() * cam.w2s_height
    o = torch.stack([px, py, torch.zeros_like(px)], -1)
    return o, normalized(o - torch.tensor(cam.render_ray_focus, device=DEV))


# tile 3 of the 1080p frame: a tile-major band through the middle of the image
o_prim, d_prim = tile_rays(cfg, 3)


def shade_args(scene, c, o, d, active, ior, w, budget, frefl):
    """The node kernels' 21 inputs (shade_eval; shade_eval_rows adds pix)."""
    hit, hval, point, d = trace._cast_active(scene, c, o, d, active)
    return trace._node_args(scene, hit, hval, point, d, ior, w, budget, frefl)


def shade_kw(scene, c):
    return trace._node_kw(scene, c, float(c.camera.epsilon_distance))


def prim_state(n):
    return dict(
        ior=torch.full((n,), trace.AIR, device=DEV), w=torch.ones((n, 3), device=DEV),
        budget=torch.full((n,), -1, dtype=torch.int32, device=DEV),
        frefl=torch.zeros(n, dtype=torch.bool, device=DEV),
    )


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


def cast_ops(scene, o, d, t_final):
    """Pair tests a front-to-back gated scan needs on this data: every big
    triangle, plus the B triangles of each block the segment [0, t] crosses."""
    n_real_big = int((scene.trb_pack[:, 13] != 0).sum())
    B = scene.tri_cast_pack.shape[1]
    crossed = gate_hits(scene.tri_aabb, o, d, t_final).sum()
    return OPS_TRI * (o.shape[0] * n_real_big + B * int(crossed))


def shade_ops(scene, point, normal, hval, epilogue):
    """Operations the shading needs on this data: per lit (ray, light) pair
    the shadow scan up to the first opaque occluder (spheres, then big
    triangles, then the crossed blocks), plus per-pair and per-ray shading,
    over the scene's n_lights lights."""
    P = point[hval]
    N = normal[hval]
    n_sph = int((scene.sph_pack[:, 12] != 0).sum())
    ops = epilogue * int(hval.sum())
    for li in range(scene.n_lights):
        lp = scene.light_pack[li, 0:3]
        ltp = lp[None, :] - P
        lt = ltp.norm(dim=1)
        lit = (ltp * N).sum(1) / lt > 0
        ops += OPS_LIGHT * int(lit.sum())
        ld = ltp[lit] / lt[lit, None]
        so = P[lit] + ld * eps
        maxd = (lp[None, :] - so).norm(dim=1)
        n = so.shape[0]
        ops += OPS_SPHERE * n_sph * n
        sp = scene.sph_pack
        st, sv = _sphere_ts(sp[:, 0:3], sp[:, 3], sp[:, 12] != 0, so, ld)
        opq = (sv & (st <= maxd[:, None]) & (sp[None, :, 8] == 0)).any(1)
        o4 = _homogeneous(so)
        live = ~opq  # not yet blocked by an opaque occluder
        packs = [(scene.trb_pack, None)] + [
            (scene.tri_blk_pack[b], scene.tri_blk_aabb[b])
            for b in range(scene.tri_blk_pack.shape[0])
        ]
        for pack, box in packs:
            scan = live if box is None else live & gate_hits(box[None], so, ld, maxd)[:, 0]
            t, v = _tri_block_ts(pack[:, 0:12].T, pack[:, 12], pack[:, 13], o4, ld)
            stop = v & (t <= maxd[:, None]) & (pack[None, :, 14] == 0)
            n_rows = int((pack[:, 13] != 0).sum()) if box is None else pack.shape[0]
            rows = torch.where(stop.any(1), stop.float().argmax(1) + 1,
                               torch.full_like(maxd, n_rows, dtype=torch.long))
            ops += OPS_TRI * int(rows[scan].sum())
            live = live & ~(scan & stop.any(1))
    return ops


results = {name: {} for name in kernels.KERNEL_SOURCES}


def record(name, label, n, err, ms, plain, byts, ops, extra=""):
    b, by = bound_ms(byts, ops)
    log(f"{name} {label}: R={n} max_abs_err={err:.3g} kernel {ms:.4f} ms, twin {plain:.3f} ms, "
        f"bound {b:.4f} ms ({by}){extra}")
    results[name][label] = dict(R=n, err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)


def check_cast(label, o, d, iters):
    cast_args = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    t, i = kernels.cast_triangles(*cast_args, o, d, sb_sizes=ds.sb_sizes)
    t_ref, i_ref = kernels.cast_triangles_plain(ds.trb_pack, ds.tri_cast_pack, o, d)
    torch.cuda.synchronize()
    assert torch.equal(i, i_ref), f"cast {label}: indices differ at {int((i != i_ref).sum())} rays"
    err = max_err(t, t_ref)
    fin = torch.isfinite(t_ref)
    assert torch.allclose(t[fin], t_ref[fin], rtol=1e-6, atol=0), f"cast {label}: t off by {err}"
    ms = cuda_ms(lambda: kernels.cast_triangles(*cast_args, o, d, sb_sizes=ds.sb_sizes), iters)
    plain = cuda_ms(lambda: kernels.cast_triangles_plain(ds.trb_pack, ds.tri_cast_pack, o, d), 3, 1)
    record("cast_triangles", label, o.shape[0], err, ms, plain,
           nbytes(o, d, *cast_args, t, i), cast_ops(ds, o, d, t))


def close(label, pairs):
    """Max |kernel - twin| over (kernel, twin) pairs, each held to the
    traced-colour bar (rtol 2e-5, atol 2e-6)."""
    err = max(max_err(a, b) for a, b in pairs)
    for a, b in pairs:
        assert torch.allclose(a, b, rtol=2e-5, atol=2e-6), f"{label}: off by {err}"
    return err


def check_rows(label, args, iters):
    kw = shade_kw(ds, cfg)
    got = kernels.shade_eval_rows(*args, **kw)
    ref = kernels.shade_eval_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    contrib, rfl, rfl_m, rfr, rfr_m = got
    c_ref, rfl_ref, rfl_m_ref, rfr_ref, rfr_m_ref = ref
    n_mask = int((rfl_m != rfl_m_ref).sum() + (rfr_m != rfr_m_ref).sum())
    assert n_mask == 0, f"shade_eval_rows {label}: {n_mask} child masks differ"
    err = close(f"shade_eval_rows {label}", [
        (contrib, c_ref), (rfl[rfl_m], rfl_ref[rfl_m]), (rfr[rfr_m], rfr_ref[rfr_m])])
    ms = cuda_ms(lambda: kernels.shade_eval_rows(*args, **kw), iters)
    plain = cuda_ms(lambda: kernels.shade_eval_rows_plain(*args, **kw), 2, 1)
    point, normal, hval = args[5], args[6], args[10] != 0
    record("shade_eval_rows", label, point.shape[0], err, ms, plain, nbytes(*args, *got),
           shade_ops(ds, point, normal, hval, OPS_EPILOGUE),
           f"; children refl {int(rfl_m.sum())} refr {int(rfr_m.sum())}")
    return got


def check_light(label, scene, args, iters):
    kw = dict(n_lights=scene.n_lights, eps_dist=eps, n_trans_blocks=scene.n_trans_blocks,
              bigtri_trans_rows=scene.bigtri_trans_rows)
    got = kernels.light_shade(*args, **kw)
    ref = kernels.light_shade_plain(*args, **kw)
    torch.cuda.synchronize()
    err = close(f"light_shade {label}", list(zip(got, ref)))
    ms = cuda_ms(lambda: kernels.light_shade(*args, **kw), iters)
    plain = cuda_ms(lambda: kernels.light_shade_plain(*args, **kw), 2, 1)
    point, normal, hval = args[5], args[6], args[10] != 0
    record("light_shade", label, point.shape[0], err, ms, plain, nbytes(*args, *got),
           shade_ops(scene, point, normal, hval, OPS_LIGHT_EPILOGUE),
           f"; {scene.n_lights} lights in {scene.light_pack.shape[0]} rows, "
           f"lit rays {int((got[0].amax(1) > 0).sum())}")


def check_fields(label, scene, c, args, iters):
    kw = shade_kw(scene, c)
    got = kernels.shade_eval(*args, **kw)
    ref = kernels.shade_eval_plain(*args, **kw)
    torch.cuda.synchronize()
    (contrib, refl, refr), (c_ref, refl_ref, refr_ref) = got, ref
    pairs = [(contrib, c_ref)]
    for g, r in ((refl, refl_ref), (refr, refr_ref)):
        m = r["mask"]
        assert torch.equal(g["mask"], m), f"shade_eval {label}: child masks differ"
        assert torch.equal(g["budget"][m], r["budget"][m]), f"shade_eval {label}: budgets"
        pairs += [(g[k][m], r[k][m]) for k in r if k not in ("mask", "budget")]
    err = close(f"shade_eval {label}", pairs)
    ms = cuda_ms(lambda: kernels.shade_eval(*args, **kw), iters)
    plain = cuda_ms(lambda: kernels.shade_eval_plain(*args, **kw), 2, 1)
    point, normal, hval = args[5], args[6], args[10] != 0
    outs = [contrib, *refl.values(), *refr.values()]
    record("shade_eval", label, point.shape[0], err, ms, plain, nbytes(*args, *outs),
           shade_ops(scene, point, normal, hval, OPS_EPILOGUE),
           f"; children refl {int(refl['mask'].sum())} refr {int(refr['mask'].sum())}")


# ---- phase 2: kernels against their twins at the paths' shapes -----------
with phase("kernels"):
    # the pool path's prologue: the realistic tile's primary rays
    check_cast("R", o_prim, d_prim, 50)
    ones = torch.ones(R, dtype=torch.bool, device=DEV)
    args_R = shade_args(ds, cfg, o_prim, d_prim, ones, **prim_state(R))
    pix_R = torch.arange(R, dtype=torch.int32, device=DEV)
    _, rfl_rows, rfl_m, rfr_rows, rfr_m = check_rows("R", (*args_R, pix_R), 30)

    # one pool iteration: the LIFO top of the tile's first pool, W child rows
    rows = torch.cat([rfr_rows, rfl_rows])[torch.cat([rfr_m, rfl_m])]
    assert rows.shape[0] >= W, rows.shape
    e = trace._unpack_entry(rows[-W:].contiguous())
    active = torch.ones(W, dtype=torch.bool, device=DEV)
    o_w, d_w = trace._park(e["o"], e["d"], active)
    check_cast("W", o_w.contiguous(), d_w, 200)
    args_W = shade_args(ds, cfg, e["o"], e["d"], active, e["ior"], e["w"], e["budget"],
                        e["from_refl"])
    check_rows("W", (*args_W, e["pix"].to(torch.int32)), 100)

    # light_shade: the same 1080p tile under `default` (5 lights) and
    # `soft_shadows` (50 lights)
    scenes = {}
    for name in ("default", "soft_shadows"):
        c = RenderConfig(width=1920, height=1080, **MAIN, **LIGHTING[name])
        scenes[name] = RaytracerRenderer(c, device="cuda").device_scene(build("semesterbild", c))
        sc = scenes[name]
        hit, hval, point, d = trace._cast_active(sc, c, o_prim, d_prim, ones)
        light_args = (sc.light_pack, sc.sph_pack, sc.trb_pack, sc.tri_blk_pack, sc.tri_blk_aabb,
                      point, hit.normal.contiguous(), d.contiguous(), hit.color.contiguous(),
                      hit.shininess.contiguous(), hval.float())
        check_light("R" if name == "default" else "R_soft", sc, light_args,
                    30 if name == "default" else 10)

    # shade_eval: the first wavefront of a 960x540 stack-path tile
    cfg_stack = RenderConfig(width=960, height=540, **dict(MAIN, compaction_ratio=1),
                             **REALISTIC)
    ds_stack = RaytracerRenderer(cfg_stack, device="cuda").device_scene(
        build("semesterbild", cfg_stack))
    o_s, d_s = tile_rays(cfg_stack, 1)
    assert o_s.shape[0] == R
    check_fields("R", ds_stack, cfg_stack,
                 shade_args(ds_stack, cfg_stack, o_s, d_s, ones, **prim_state(R)), 30)

    # the chunk commit: one chunk's rows (96 x W) onto the tile's pixels
    rng = np.random.default_rng(0)
    n_rows = cfg.loop_chunk * W
    pix = torch.from_numpy(rng.integers(0, R + 1, n_rows)).to(DEV)
    contrib = torch.from_numpy(rng.uniform(0, 1, (n_rows, 3)).astype(np.float32)).to(DEV)
    base = torch.from_numpy(rng.uniform(0, 1, (R + 1, 3)).astype(np.float32)).to(DEV)
    sums = []
    for _ in range(3):
        acc = base.clone()
        trace._commit(acc, pix, contrib)
        sums.append(acc)
    assert all(torch.equal(sums[0], s) for s in sums[1:]), "the commit is not deterministic"
    commit_ms = cuda_ms(lambda: trace._commit(base.clone(), pix, contrib), 20)
    atomic_ms = cuda_ms(lambda: base.clone().index_add_(0, pix, contrib), 20)
    log(f"chunk commit ({n_rows} rows onto {R + 1}): identical bits over 3 runs; "
        f"sorted {commit_ms:.4f} ms, index_add_ {atomic_ms:.4f} ms")
    report["commit"] = dict(rows=n_rows, sorted_ms=commit_ms, index_add_ms=atomic_ms)


def run_frame(r, scene):
    """One frame: (u32 pixels, wall s, launches, dropped)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    fb = r.render_u32(scene)
    torch.cuda.synchronize()
    return fb, time.monotonic() - t0, dict(kernels.LAUNCHES), r.last_dropped


frames = {}


def frame_phase(label, c, r, scene, expect):
    """Warm frame of one path: the kernels in `expect` launched, every other
    kernel not launched, dropped == 0."""
    run_frame(r, scene)  # warm-up (allocator, caches)
    fb, wall, launches, dropped = run_frame(r, scene)
    valid = float((fb != 0).mean())
    log(f"{label} ({c.width}x{c.height}): warm frame {wall * 1e3:.1f} ms, launches {launches}, "
        f"dropped {dropped}, valid {valid:.4f}, u32 sha256 {checksum(fb)}")
    assert fb.shape == (c.width * c.height,)
    for k, v in launches.items():
        assert (v > 0) == (k in expect), (label, launches)
    assert dropped == 0, dropped
    assert valid > 0.5, valid
    frames[label] = dict(size=f"{c.width}x{c.height}", wall_ms=wall * 1e3, launches=launches,
                         dropped=dropped, checksum=checksum(fb), valid_share=valid)
    return fb, wall


# ---- phase 3: the 1080p realistic frame (packed-row pool path) -----------
with phase("realistic"):
    fb1, _ = frame_phase("realistic", cfg, renderer, ds, ("cast_triangles", "shade_eval_rows"))
    fb2, wall2, _, _ = run_frame(renderer, ds)
    assert checksum(fb1) == checksum(fb2), "two warm realistic frames differ"
    log(f"second warm realistic frame: {wall2 * 1e3:.1f} ms, same u32 checksum")
    frames["realistic"]["wall_ms_second"] = wall2 * 1e3

    # the commit A/B in one process: the atomic index_add_ against the
    # sorted commit, in turns old, new, new, old
    sorted_commit = trace._commit
    walls = {"index_add_": [], "sorted": []}
    sums = {"index_add_": set(), "sorted": set()}
    for which in ("index_add_", "sorted", "sorted", "index_add_"):
        trace._commit = ((lambda acc, p, v: acc.index_add_(0, p, v))
                         if which == "index_add_" else sorted_commit)
        fb, wall, _, _ = run_frame(renderer, ds)
        walls[which].append(wall * 1e3)
        sums[which].add(checksum(fb))
    trace._commit = sorted_commit
    log(f"commit A/B, realistic 1080p warm frame ms: index_add_ {walls['index_add_']}, "
        f"sorted {walls['sorted']}; checksums index_add_ {sorted(sums['index_add_'])}, "
        f"sorted {sorted(sums['sorted'])}")
    assert sums["sorted"] == {checksum(fb1)}
    report["commit_ab"] = dict(wall_ms=walls, checksums={k: sorted(v) for k, v in sums.items()})

# ---- phase 3b: where one tile's time goes (torch.profiler) ----------------
with phase("profile"):
    # tile 3 again, traced: host wall vs summed device time of every kernel
    order3 = torch.from_numpy(np.ascontiguousarray(plan.order[3 * R: 4 * R])).to(DEV)
    offs = torch.zeros((1, 3), device=DEV)
    per_tile = trace.make_raygen_per_tile(ds, cfg, offs, torch.ones(1, device=DEV), R)
    per_tile(order3)  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        per_tile(order3)
        torch.cuda.synchronize()
        tile_wall = (time.monotonic() - t0) * 1e3
    iters = kernels.LAUNCHES["shade_eval_rows"] - 1  # minus the prologue
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg) / 1e3
    n_launch = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:6]
    log(f"tile 3 traced: wall {tile_wall:.1f} ms, pool iterations {iters}, device busy "
        f"{busy:.1f} ms ({'not measured' if busy == 0 else f'idle {1 - busy / tile_wall:.1%}'}), "
        f"{n_launch} kernel launches ({n_launch / (iters + 1):.0f} per node evaluation)")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms device  x{e.count:<6d} {e.key[:70]}")
    report["tile_profile"] = dict(
        wall_ms=tile_wall, iterations=iters, device_busy_ms=busy, launches=n_launch,
        top=[dict(key=e.key, device_ms=e.self_device_time_total / 1e3, count=e.count)
             for e in top],
    )

# ---- phase 4: the other paths at their sizes -----------------------------
with phase("paths"):
    for name in sorted(LIGHTING):
        c = RenderConfig(width=1920, height=1080, **MAIN, **LIGHTING[name])
        r = RaytracerRenderer(c, device="cuda")
        sc = scenes.get(name) or r.device_scene(build("semesterbild", c))
        p = plan_frame(c)
        log(f"{name}: {p.n_tiles} tiles x {p.pix_per_tile * p.aa} rays ({p.aa} per pixel), "
            f"{sc.n_lights} lights")
        frame_phase(name, c, r, sc, ("cast_triangles", "light_shade"))
    frame_phase("stack", cfg_stack, RaytracerRenderer(cfg_stack, device="cuda"), ds_stack,
                ("cast_triangles", "shade_eval"))
    cfg_unpacked = RenderConfig(width=240, height=135, **dict(MAIN, packed_stage=False),
                                **REALISTIC)
    r_unpacked = RaytracerRenderer(cfg_unpacked, device="cuda")
    frame_phase("unpacked", cfg_unpacked, r_unpacked,
                r_unpacked.device_scene(build("semesterbild", cfg_unpacked)),
                ("cast_triangles", "shade_eval"))


def linear(f):
    return np.stack([(f >> s) & 0xFF for s in (16, 8, 0)], -1).astype(np.float32) / 255.0


# ---- phase 5: small frames, card against the CPU twins --------------------
SMALL = {
    "realistic": (240, 135, REALISTIC),
    "unpacked": (240, 135, dict(REALISTIC, packed_stage=False)),
    "stack": (120, 68, dict(REALISTIC, compaction_ratio=1)),
    "default": (240, 135, LIGHTING["default"]),
    "anti_aliasing": (120, 68, LIGHTING["anti_aliasing"]),
    "soft_shadows": (120, 68, LIGHTING["soft_shadows"]),
}
with phase("card_vs_cpu"):
    report["image_check"] = {}
    for label, (w, h, feats) in SMALL.items():
        c = RenderConfig(width=w, height=h, **dict(MAIN, **feats))
        out = {}
        for dev in ("cuda", "cpu"):
            r = RaytracerRenderer(c, device=dev)
            t0 = time.monotonic()
            out[dev] = r.render_u32(r.device_scene(build("semesterbild", c)))
            assert r.last_dropped == 0
            out[dev + "_s"] = time.monotonic() - t0
        gpu, cpu = out["cuda"], out["cpu"]
        valid_diff = int(((gpu != 0) != (cpu != 0)).sum())
        off = int((np.abs(linear(gpu) - linear(cpu)).max(-1) > 2e-3).sum())
        n_px = gpu.size
        log(f"{label} {w}x{h} card vs CPU twins: {off} of {n_px} pixels off by > 2e-3 "
            f"({off / n_px:.4%}), valid differs at {valid_diff} (knife edges); card "
            f"{out['cuda_s']:.1f} s, CPU {out['cpu_s']:.1f} s")
        assert off < 0.005 * n_px and valid_diff < 0.005 * n_px, label
        assert (gpu != 0).mean() > 0.5, label
        report["image_check"][label] = dict(size=f"{w}x{h}", pixels=n_px, off=off,
                                            valid_diff=valid_diff)

# ---- phase 6: results ----------------------------------------------------
# each kernel's launches: from the path it serves (the frame of phase 3/4)
ENTRIES = {
    "cast_triangles": ("cast_triangles.cu", 301, "realistic", "R", "W"),
    "shade_eval_rows": ("shade_eval_rows.cu", 1858, "realistic", "R", "W"),
    "light_shade": ("light_shade.cu", 1834, "default", "R", "R_soft"),
    "shade_eval": ("shade_eval.cu", 1858, "stack", "R", None),
}
EXTRA = {"W": "pool", "R_soft": "soft"}
line = []
for name, (src, tpu_line, path, main, second) in ENTRIES.items():
    m = results[name][main]
    entry = dict(
        name=name, route="cuda", source=f"{PKG}/csrc/{src}",
        replaces=f"{TPU_KERNELS}:{tpu_line}", launches=frames[path]["launches"][name],
        max_abs_err=max(v["err"] for v in results[name].values()), ms=m["ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=None, launches_path=path,
    )
    if second:
        s = results[name][second]
        sfx = EXTRA[second]
        entry.update({f"ms_{sfx}": s["ms"], f"plain_ms_{sfx}": s["plain_ms"],
                      f"bound_ms_{sfx}": s["bound_ms"], f"bound_by_{sfx}": s["bound_by"]})
    line.append(entry)
report["kernels"] = line
report["frames"] = frames
if ARGS.report:
    os.makedirs(os.path.dirname(os.path.abspath(ARGS.report)), exist_ok=True)
    with open(ARGS.report, "w") as fh:
        json.dump(report, fh, indent=1)
log(f"phases (s): {json.dumps({k: round(v, 1) for k, v in report['phase_s'].items()})}")
print(json.dumps({"kernels": line}), flush=True)
print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                         "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}), flush=True)
