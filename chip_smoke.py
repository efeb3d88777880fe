"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases (any failure fails the run; nothing is caught; each prints its
seconds):
  1. the card's name and power limit; build all seven CUDA kernels from
     hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/csrc (one nvcc each, in
     parallel) and print the build time and the registers of each kernel
     function and form (ptxas);
  2. hold each kernel against its plain PyTorch twin on the card at its
     path's shapes, taken from real semesterbild tiles, and time both with
     CUDA events: cast_triangles and shade_eval_rows at R = 131072 (the
     prologue of a 1080p `realistic` tile) and W = 2048 (one pool
     iteration), the same bits on three runs, and shade_eval_rows bit for
     bit against shade_eval on the same inputs; light_shade at R = 131072
     from a 1080p tile with 5 lights (`default`) and 50 lights
     (`soft_shadows`), the same bits on three runs; shade_eval at the first and the middle wavefront of
     tile 1 of the 960x540 stack-path frame (131072 slots, caught from a
     render, with the live rays of every wavefront) and at the first pool
     iteration of the 240x135 `packed_stage=False` frame (W = 512), in both
     of its forms bit for bit shade_eval_rows, three runs each; at many
     lights, shade_eval_rows at R and W of tile 3 of the reference_default
     frame (1140x950, nine AA samples a pixel, R = 131,067, 95 lights) and
     of the extreme frame (480x270, R = 262,140, 140 lights), the same bits
     on three runs, and shade_eval at a stack wavefront of reference_default
     at the CLI's tile_rays (8192). The six
     kernels with a warp per ray or a (ray, light) split are also timed on
     the device alone (torch.profiler). Then the pool's chunk commit three
     times on the same rows: identical bits. Phase 2b:
     cast_triangles_stream and occlude_triangles_stream on the synthetic
     streaming validation scene (200,000 small matte triangles in a 10^3
     box, R = 32768 random rays, max distance 4, backface culling on; and
     the same cloud with a quarter of it glass), at the shapes of the
     streamed frame (the primary node of a 1080p tile: 131072 rays and
     their 655,360 shadow rays; one pool iteration: 2048 rays and 10,240
     shadow rays); occlude_triangles on the 655,360 shadow rays of the
     resident 1080p tile and the 10,240 of its first pool iteration, in
     both of its forms bit for bit, timed on the device alone too, and once
     on the 655,360 through `occlude_rays(scene, ...)`. Occlusion sums are
     compared where `opq` is false and must have the same bits on every
     run. For the two streamed kernels (one warp per ray, a two-level box
     gate) each line also gives the superblocks and blocks a ray crosses
     and the operations of the gate's box tests (this design's own work,
     kept out of `bound_ms`). Phase 2c: the five kernels with a warp per
     ray and shade_eval on block partitions the JAX package takes, a
     superblock of more than 32 blocks and blocks of 48 rows (a cloud scene
     at 1080p), against their twins at W and R rays (and their shadow
     rays), occlude_triangles also in its other form bit for bit;
  3. render the full 1920x1080 `realistic` frame (bench.py's settings, the
     packed-row pool path) through RaytracerRenderer(cfg, device="cuda"):
     warm frame wall time, launch counts (cast_triangles and
     shade_eval_rows > 0, the others 0), dropped rays (0), the rays left
     at the iteration cap (`unfinished`; every frame of the run), and the u32
     checksum, the warm-up frame's too; then the
     frame with the atomic commit (`index_add_`) against the sorted
     commit, in turns old, new, new, old; then three tiles traced with
     torch.profiler (the `realistic` tile 3, the stack-path tile 1 and the
     `soft_shadows` tile 3): wall, node evaluations, device busy time, the
     kernels that take it, and the device time of each node-kernel call;
  4. the other paths at their sizes: 1080p `default`, `anti_aliasing` and
     `soft_shadows` (light_shade > 0, shade_eval_rows == 0), the 960x540
     stack-path frame (compaction_ratio 1; shade_eval > 0, shade_eval_rows
     == 0) and a 240x135 `packed_stage=False` frame (shade_eval > 0): warm
     wall, launches, dropped, valid share, u32 checksum; then the streamed
     frame: 1920x1080 `realistic` on semesterbild plus a seeded cloud of
     120,000 small triangles (`streaming` set by the threshold), through
     cast_triangles_stream and occlude_triangles_stream only: a warm-up
     and a warm frame with one checksum, pool iterations, the share of primary rays
     that hit the cloud, and one tile traced with torch.profiler.
     Every warm frame's checksum must be the one recorded for its path
     (CHECKSUMS: an H100's, the same in every run);
  5. small frames of every path on the card and through the CPU twins,
     and of the cloud scene at the two partitions of phase 2c (the twins'
     frames of phases 5-7 are rendered by a process of their own,
     utils/harness.py::twin_frames, started after phase 3 and ended in
     phase 7, while the card runs the phases between): < 0.5% of pixels may differ by more than 2e-3 in linear colour,
     and `valid` may differ only at knife edges (< 0.5%);
  6. the user's entry points: reference_default at 1140x950 through the
     f32 frame path (`device_encode=False`: host-built rays, the AA samples
     reduced on the host) and the u32 path, the two frames' `valid`
     identical and their u8 pixels at most one step apart at under 1% of
     pixels, walls, launches, dropped and the u32 checksum; extreme at
     480x270, two u32 frames with one checksum; tile 3 of each traced
     with torch.profiler, as in phase 3b; the CLI (`python -m
     hslu_i.ba_raytracing.f2501_raytracer_tpu_torch`) in a process of its
     own for semesterbild/realistic at 768x640, test_scene/default and
     test_text/realistic at 384x320, each PNG (beside the --report file,
     or in out/) equal to
     the frame rendered in this process; the progressive path on a 228x190
     reference_default frame, bit for bit the fused f32 frame, and
     `get_pixel_color` at five of its pixels; reference_default's and
     extreme's flags at 40x30 and 20x15 on the card and through the CPU
     twins (the pool path at kernel_ray_tile 64, compaction_ratio 8), at
     phase 5's bar;
  7. the reference's SIMD build and the pool's knobs: reference_default
     with packet_mode (16 AA lanes a pixel, two packets; 133 tiles of
     131,072 rays, 95 lights) at 1140x950 once, its launches (cast_triangles
     and light_shade only), dropped and u32 checksum, after a 228x190
     packet frame with its own checksum; its middle tile traced with
     torch.profiler and light_shade held against its twin at R and W of
     that tile; the packet flags at 24x18 (resident) and 12x10 (streamed)
     on the card and through the CPU twins at phase 5's bar; the 1080p
     `realistic` frame with stage_mode gather and commit_splits 2, and with
     stage_mode unique and commit_splits 8 (its checksum: in the port
     these knobs change nothing), with resort_secondary twice (one checksum;
     phase 5's bar against phase 3's frame); the 1080p `default` frame
     with fetch_groups 1 and 8 in turns (its checksum); autotune's
     triangle_block over (32, 64, 128, 256, 512) on the `realistic` scene,
     each candidate's ms, and the tuned frame at phase 5's bar against
     phase 3's;
  7b. multi-device rendering (parallel/mesh.py) on a mesh that lists the
     card several times (each entry a host thread and a stream of its own;
     no scaling is measured): the 1080p `realistic` frame through
     RaytracerRenderer(devices=2 and 4, device=["cuda:0"] * k) and the
     1080p `default` frame at devices=4, each twice (a first and a warm
     frame, as phase 3 runs a path) with its one-device checksum and
     launches and dropped 0, its walls beside the one-device walls; on a
     host with more cards, `realistic` on all of them, on one card
     RaytracerRenderer(devices=2) raising; cast_nearest_objsharded on four
     entries over the streamed cloud scene (blocks padded to a multiple of
     4), tile 3's 131,072 primary rays, against the dense cast (valid and
     object index identical, t within 1e-6 relative; 4 launches of
     cast_triangles_stream); render_image_sharded and trace_rays_sharded
     on tile 3 of `default` bit for bit trace_rays, and on tile 3 of
     `realistic` within tests/test_multichip.py's bar;
  8. every frame's `unfinished` count (the rays left untraced at the
     iteration cap): 0, but for the open faults of UNFINISHED_OPEN; print
     the {"kernels": [...]} line, then the {"ok": true, ...} line.
With --report, the measurements also go to PATH as JSON.

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import hashlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--report", help="also write the measurements to this JSON file")
ARGS = parser.parse_args()

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(2)

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (  # noqa: E402
    ImageBuffer,
    RaytracerRenderer,
    RenderConfig,
    autotune,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import build_device_scene  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models.triangle_cloud import (  # noqa: E402
    add_triangle_cloud,
    build_scene as build_cloud,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import (  # noqa: E402
    _homogeneous,
    _sphere_ts,
    _tri_block_ts,
    cast_rays,
    occlude_packs,
    occlude_rays,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output import read_png  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import parallel  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.scene.builder import Scene  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import (  # noqa: E402
    launch_groups,
    plan_frame,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness import (  # noqa: E402
    OPS_OCCL,
    PARTITIONS,
    PEAK_F32,
    assert_node_bits,
    bound_ms,
    caught_calls,
    cuda_ms,
    device_ms,
    gate_hits,
    nbytes,
    occlusion_tests,
    same_bits,
    same_occlusion,
    shadow_rays,
    tile_call,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.timing import (  # noqa: E402
    device_busy_ms,
)

PKG = "hslu_i/ba_raytracing/f2501_raytracer_tpu_torch"
TPU_KERNELS = "hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py"
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
# the reference's own configuration (config.py reference_default: realistic,
# AA rotation + randomness, high_quality: a cloud of 19 lights per light,
# depths 13/18, the hq block size; 1140x950) and bench.py:49-57's extreme
# (140 lights, depths 21/21, ~17 rays per pixel) at bench.py's 480x270 and
# 262,144-ray tiles (bench.py:222-234), both at bench.py's other settings
EXTREME = dict(REALISTIC, anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True,
               extreme_quality=True, high_quality_model=True)
CFG_REF = RenderConfig.reference_default(
    **{k: v for k, v in MAIN.items() if k != "scene_backface_culling"})
CFG_EXT = RenderConfig(width=480, height=270, **dict(MAIN, tile_rays=262144), **EXTREME)
ROOT_DIR = os.path.dirname(os.path.abspath(__file__))
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


def timed_run(fn):
    """(fn's result, wall s, launches) of one synchronised call, every
    launch count set to 0 just before it."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0, dict(kernels.LAUNCHES)


def run_frame(r, scene):
    """One frame: (u32 pixels, wall s, launches, dropped)."""
    fb, wall, launches = timed_run(lambda: r.render_u32(scene))
    return fb, wall, launches, r.last_dropped


# the rays left untraced at the iteration cap (`last_unfinished`) of every
# frame this run renders, by label; 0 unless the frame is named in
# UNFINISHED_OPEN (an open fault, ROADMAP.md Queue 3), checked in phase 8
unfinished = {}
UNFINISHED_OPEN = {}


def note_unfinished(label, r):
    """Record renderer r's last frame as frame `label`; returns its count."""
    unfinished[label] = r.last_unfinished
    return r.last_unfinished


def max_err(a, b):
    a, b = a.float(), b.float()
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin), "non-finite values differ"
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def checksum(fb):
    return hashlib.sha256(fb.tobytes()).hexdigest()[:16]


# the kernels whose lines also give the time on the device alone
# (torch.profiler) and the registers per thread of each build (form); those
# with a warp per ray must not spill (light_shade, one lane per shadow ray,
# spills a few bytes in its fastest build)
TIMED_KERNELS = ("cast_triangles", "cast_triangles_stream", "occlude_triangles_stream",
                 "occlude_triangles", "shade_eval_rows", "shade_eval", "light_shade")
NO_SPILL = TIMED_KERNELS[:-1]


def entry_registers(ptxas):
    """{kernel function and its template arguments: (registers, spilled
    bytes)} from a build's ptxas -v output."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # ...<length><name>_kernel, then I<template arguments>E: K, RAGGED, WIDE
            f = re.search(r"\d([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            args = re.findall(r"(\d+)E", f.group(2) or "") if f else []
            name = (f.group(1) if f else m.group(1)) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [None, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


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
    n_cached = sum(info["cached"] for info in built.values())
    log(f"kernel build: {report['build_s']:.1f} s (parallel nvcc, {len(built)} kernels, "
        f"{n_cached} of them found built: their ptxas lines are those of that build)")
    assert sorted(built) == sorted(kernels.KERNEL_SOURCES), built
    report["ptxas"] = {}
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
        report["ptxas"][name] = dict(
            registers=[int(n) for n in re.findall(r"Used (\d+) registers", info["ptxas"])],
            spill_bytes=sum(int(n) for n in re.findall(r"(\d+) bytes spill", info["ptxas"])),
            cached=info["cached"])
    for name in TIMED_KERNELS:
        regs = report["ptxas"][name]
        regs["forms"] = {f: r for f, (r, _) in entry_registers(built[name]["ptxas"]).items()}
        log(f"{name}: registers per thread by kernel and form {regs['forms']}, "
            f"{regs['spill_bytes']} bytes spilled "
            f"({'a cached build' if regs['cached'] else 'this run'}'s ptxas)")
        assert regs["registers"] and (regs["spill_bytes"] == 0 or name not in NO_SPILL), regs

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


def cast_ops(scene, o, d, t_final):
    """Pair tests a front-to-back gated scan needs on this data: every big
    triangle, plus the B triangles of each block the segment [0, t] crosses."""
    n_real_big = int((scene.trb_pack[:, 13] != 0).sum())
    B = scene.tri_cast_pack.shape[1]
    crossed = gate_hits(scene.tri_aabb, o, d, t_final).sum()
    return OPS_TRI * (o.shape[0] * n_real_big + B * int(crossed))


def shade_ops(scene, point, normal, hval, epilogue, eps_dist=None):
    """Operations the shading needs on this data: per lit (ray, light) pair
    the shadow scan up to the first opaque occluder (spheres, then big
    triangles, then the crossed blocks), plus per-pair and per-ray shading,
    over the scene's n_lights lights (shadow rays leave the surface by
    `eps_dist`, default the 1080p frame's)."""
    eps_dist = eps if eps_dist is None else eps_dist
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
        so = P[lit] + ld * eps_dist
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


def alone(res, n_rays, dev_ms, n_lights=None):
    """The time on the device alone of a resident kernel with a warp per
    ray (the CUDA events above also time the wrapper's host work);
    shade_eval_rows gives its light count, with which a wavefront may take
    its light-lanes form (kernels.node_form)."""
    k = kernels.rays_per_warp(n_rays, many=32)
    res.update(device_ms=dev_ms, rays_per_warp=k)
    form = f"{k} rays per warp"
    if n_lights is not None and kernels.node_form(n_rays, n_lights) == kernels.LIGHT_LANES:
        res.update(form="light lanes")
        form = "a warp per ray, its lights over the lanes"
    log(f"  on the device alone {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}; "
        f"{form}")


def check_cast(label, o, d, iters):
    cast_args = (ds.trb_pack, ds.tri_cast_pack, ds.tri_aabb, ds.tri_saabb)
    t, i = kernels.cast_triangles(*cast_args, o, d, sb_sizes=ds.sb_sizes)
    t_ref, i_ref = kernels.cast_triangles_plain(ds.trb_pack, ds.tri_cast_pack, o, d)
    torch.cuda.synchronize()
    assert torch.equal(i, i_ref), f"cast {label}: indices differ at {int((i != i_ref).sum())} rays"
    err = max_err(t, t_ref)
    fin = torch.isfinite(t_ref)
    assert torch.allclose(t[fin], t_ref[fin], rtol=1e-6, atol=0), f"cast {label}: t off by {err}"
    for _ in range(2):
        t2, i2 = kernels.cast_triangles(*cast_args, o, d, sb_sizes=ds.sb_sizes)
        assert same_bits(t2, t) and torch.equal(i2, i), f"cast {label}: runs differ"
    fn = lambda: kernels.cast_triangles(*cast_args, o, d, sb_sizes=ds.sb_sizes)  # noqa: E731
    ms = cuda_ms(fn, iters)
    plain = cuda_ms(lambda: kernels.cast_triangles_plain(ds.trb_pack, ds.tri_cast_pack, o, d), 3, 1)
    record("cast_triangles", label, o.shape[0], err, ms, plain,
           nbytes(o, d, *cast_args, t, i), cast_ops(ds, o, d, t))
    alone(results["cast_triangles"][label], o.shape[0], device_ms(fn, iters))


def close(label, pairs):
    """Max |kernel - twin| over (kernel, twin) pairs, each held to the
    traced-colour bar (rtol 2e-5, atol 2e-6)."""
    err = max(max_err(a, b) for a, b in pairs)
    for a, b in pairs:
        assert torch.allclose(a, b, rtol=2e-5, atol=2e-6), f"{label}: off by {err}"
    return err


def check_rows(label, args, iters, scene=None, c=None):
    scene, c = (ds, cfg) if scene is None else (scene, c)
    kw = shade_kw(scene, c)
    got = kernels.shade_eval_rows(*args, **kw)
    ref = kernels.shade_eval_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    contrib, rfl, rfl_m, rfr, rfr_m = got
    c_ref, rfl_ref, rfl_m_ref, rfr_ref, rfr_m_ref = ref
    n_mask = int((rfl_m != rfl_m_ref).sum() + (rfr_m != rfr_m_ref).sum())
    assert n_mask == 0, f"shade_eval_rows {label}: {n_mask} child masks differ"
    err = close(f"shade_eval_rows {label}", [
        (contrib, c_ref), (rfl[rfl_m], rfl_ref[rfl_m]), (rfr[rfr_m], rfr_ref[rfr_m])])
    # the same bits as the per-field node kernel (shade_eval) on the same
    # inputs, and on every run
    assert_node_bits(got, kernels.shade_eval(*args[:-1], **kw), f"shade_eval_rows {label}")
    for _ in range(2):
        again = kernels.shade_eval_rows(*args, **kw)
        assert all(same_bits(a, b) for a, b in zip(got, again)), f"{label}: runs differ"
    fn = lambda: kernels.shade_eval_rows(*args, **kw)  # noqa: E731
    ms = cuda_ms(fn, iters)
    plain = cuda_ms(lambda: kernels.shade_eval_rows_plain(*args, **kw), 2, 1)
    point, normal, hval = args[5], args[6], args[10] != 0
    record("shade_eval_rows", label, point.shape[0], err, ms, plain, nbytes(*args, *got),
           shade_ops(scene, point, normal, hval, OPS_EPILOGUE, kw["eps_dist"]),
           f"; {scene.n_lights} lights; children refl {int(rfl_m.sum())} refr "
           f"{int(rfr_m.sum())}; bit-identical to shade_eval, the same bits on three runs")
    alone(results["shade_eval_rows"][label], point.shape[0], device_ms(fn, iters),
          kw["n_lights"])
    return got


def check_light(label, scene, args, iters, kw=None):
    kw = kw or dict(n_lights=scene.n_lights, eps_dist=eps, n_trans_blocks=scene.n_trans_blocks,
                    bigtri_trans_rows=scene.bigtri_trans_rows)
    got = kernels.light_shade(*args, **kw)
    ref = kernels.light_shade_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (got[0].amax(1) > 0).any(), f"light_shade {label}: no ray is lit"
    err = close(f"light_shade {label}", list(zip(got, ref)))
    for _ in range(2):  # the same bits on three runs
        assert all(same_bits(a, b) for a, b in zip(got, kernels.light_shade(*args, **kw))), label
    fn = lambda: kernels.light_shade(*args, **kw)  # noqa: E731
    ms = cuda_ms(fn, iters)
    plain = cuda_ms(lambda: kernels.light_shade_plain(*args, **kw), 2, 1)
    point, normal, hval = args[5], args[6], args[10] != 0
    record("light_shade", label, point.shape[0], err, ms, plain, nbytes(*args, *got),
           shade_ops(scene, point, normal, hval, OPS_LIGHT_EPILOGUE, kw["eps_dist"]),
           f"; {scene.n_lights} lights in {scene.light_pack.shape[0]} rows, "
           f"lit rays {int((got[0].amax(1) > 0).sum())}; the same bits on three runs")
    dev_ms = device_ms(fn, iters)
    results["light_shade"][label]["device_ms"] = dev_ms
    log(f"  on the device alone {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")


def node_forms_bits(label, args, kw):
    """shade_eval in both forms, three runs each: bit for bit shade_eval_rows
    on the same inputs. Returns the form the live rays choose."""
    n = args[5].shape[0]
    rows_out = kernels.shade_eval_rows(*args, torch.arange(n, dtype=torch.int32, device=DEV),
                                       **kw)
    keep = kernels.NODE_WARP_MAX_LIVE
    for most in (1 << 30, -1):  # a warp per ray; a ray per lane
        kernels.NODE_WARP_MAX_LIVE = most
        for _ in range(3):
            assert_node_bits(rows_out, kernels.shade_eval(*args, **kw), f"shade_eval {label}")
    kernels.NODE_WARP_MAX_LIVE = keep
    return "a warp per ray" if int((args[10] != 0).sum()) <= keep else "a ray per lane"


def check_fields(label, scene, c, args, iters, note=""):
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
    form = node_forms_bits(label, args, kw)
    fn = lambda: kernels.shade_eval(*args, **kw)  # noqa: E731
    ms = cuda_ms(fn, iters)
    plain = cuda_ms(lambda: kernels.shade_eval_plain(*args, **kw), 2, 1)
    point, normal, hval = args[5], args[6], args[10] != 0
    live = int(hval.sum())
    outs = [contrib, *refl.values(), *refr.values()]
    record("shade_eval", label, point.shape[0], err, ms, plain, nbytes(*args, *outs),
           shade_ops(scene, point, normal, hval, OPS_EPILOGUE, kw["eps_dist"]),
           f"; {live} live rays, {scene.n_lights} lights, {form}{note}; children refl "
           f"{int(refl['mask'].sum())} refr "
           f"{int(refr['mask'].sum())}; bit-identical to shade_eval_rows in both forms, three "
           f"runs")
    # four kernels per call: the live list, its offsets, then each form (one
    # leaves at once)
    dev_ms = device_ms(fn, iters, per_call=4)
    results["shade_eval"][label].update(device_ms=dev_ms, live=live, form=form)
    log(f"  on the device alone {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")


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

    # shade_eval: every wavefront of tile 1 of the 960x540 stack-path frame,
    # caught from a render: the first (every primary ray) and the middle one
    # (reflected and refracted rays, scattered over the slots)
    cfg_stack = RenderConfig(width=960, height=540, **dict(MAIN, compaction_ratio=1),
                             **REALISTIC)
    ds_stack = RaytracerRenderer(cfg_stack, device="cuda").device_scene(
        build("semesterbild", cfg_stack))
    stack_calls = caught_calls(["shade_eval"], tile_call(ds_stack, cfg_stack, 1))["shade_eval"]
    stack_live = [int((a[10] != 0).sum()) for a, _ in stack_calls]
    log(f"stack tile 1: {len(stack_calls)} wavefronts of {stack_calls[0][0][5].shape[0]} slots; "
        f"live rays per wavefront {stack_live}")
    report["stack_live"] = stack_live
    assert stack_calls[0][0][5].shape[0] == R and len(stack_calls) > 8
    check_fields("R", ds_stack, cfg_stack, stack_calls[0][0], 30)
    mid = len(stack_calls) // 2
    check_fields("S", ds_stack, cfg_stack, stack_calls[mid][0], 30,
                 f", wavefront {mid} of {len(stack_calls)}")
    # ... and W = 512: the first pool iteration of the 240x135 frame with
    # packed_stage=False (its second call; the first is the primary node)
    cfg_unpacked = RenderConfig(width=240, height=135, **dict(MAIN, packed_stage=False),
                                **REALISTIC)
    r_unpacked = RaytracerRenderer(cfg_unpacked, device="cuda")
    ds_unpacked = r_unpacked.device_scene(build("semesterbild", cfg_unpacked))
    (_, _), (args_w, _) = caught_calls(["shade_eval"], tile_call(ds_unpacked, cfg_unpacked, 0),
                                       2)["shade_eval"]
    assert args_w[5].shape[0] == 512, args_w[5].shape
    check_fields("W", ds_unpacked, cfg_unpacked, args_w, 100)

    # the node kernels at many lights: shade_eval_rows at R and W of tile 3
    # of reference_default's frame (95 lights: R = 131,067, nine samples a
    # pixel) and of extreme's (140 lights, R = 262,140), caught from a render
    # of the tile with its AA samples; shade_eval at the first wavefront of a
    # stack tile of reference_default at the CLI's tile_rays (8192: R = 8190,
    # below kernel_ray_tile x compaction_ratio)
    for n_l, c_hq in (("95", CFG_REF), ("140", CFG_EXT)):
        ds_hq = RaytracerRenderer(c_hq, device="cuda").device_scene(build("semesterbild", c_hq))
        assert ds_hq.n_lights == int(n_l), ds_hq.n_lights
        caught = caught_calls(["shade_eval_rows"], tile_call(ds_hq, c_hq, 3, aa=True),
                              2)["shade_eval_rows"]
        for (args_hq, _), which in zip(caught, ("R", "W")):
            check_rows(which + n_l, args_hq, 5 if which == "R" else 50, ds_hq, c_hq)
    cfg_cli_ref = RenderConfig.reference_default()
    ds_cli_ref = RaytracerRenderer(cfg_cli_ref, device="cuda").device_scene(
        build("semesterbild", cfg_cli_ref))
    p_cli = plan_frame(cfg_cli_ref)
    k_mid = p_cli.n_tiles // 2
    cli_calls = caught_calls(["shade_eval"], tile_call(ds_cli_ref, cfg_cli_ref, k_mid, aa=True)
                             )["shade_eval"]
    log(f"reference_default at the CLI's tile_rays: {p_cli.n_tiles} tiles of "
        f"{p_cli.pix_per_tile * p_cli.aa} rays; stack tile {k_mid}: live rays per wavefront "
        f"{[int((a[10] != 0).sum()) for a, _ in cli_calls]}")
    check_fields("S95", ds_cli_ref, cfg_cli_ref, cli_calls[0][0], 10,
                 f", wavefront 1 of {len(cli_calls)} of stack tile {k_mid}")

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

# ---- phase 2b: the streamed cast and the two occlusion kernels ------------
# one widened slab test of a box (rt_common.cuh::rt_gate)
OPS_BOX = 30


def timed_once(fn):
    """(result, ms) of one synchronised call: the twins of the streamed
    kernels take seconds (one PyTorch op per block and step)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def validation_scene(glass_share):
    """The synthetic scene of the streaming validation: 200,000 small
    triangles, centres uniform in a 10^3 box, edges N(0, 0.08),
    default_rng(7); at the 1080p block size (64)."""
    s = Scene()
    t0 = time.monotonic()
    add_triangle_cloud(s, 200_000, (0.0, 0.0, 0.0), (10.0, 10.0, 10.0), 0.08, 7, glass_share)
    scene = build_device_scene(s, cfg, device="cuda")
    assert scene.streaming and scene.n_triangles > cfg.stream_triangles
    n_trans = sum(scene.block_has_trans)
    assert (0 < n_trans < scene.triangle_blocks) == (glass_share > 0), n_trans
    log(f"validation scene (glass share {glass_share}): {scene.triangle_blocks} blocks of "
        f"{scene.tri_block}, {n_trans} with transmissive triangles, built in "
        f"{time.monotonic() - t0:.1f} s on the host")
    return scene


def stream_tables(scene):
    return (scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb)


def gate_work(scene, o, d, t_limit):
    """What the two-level gate of the streamed kernels does for these rays:
    (superblocks crossed, blocks crossed, the most blocks one ray crosses,
    f32 operations of its box tests: every superbox, then the boxes of the
    crossed superblocks). The box tests are this design's work, not the
    function's (a deeper hierarchy would test fewer): they stay out of the
    bound."""
    sizes = torch.tensor(scene.sb_sizes, device=DEV)
    n_sb = n_boxes = crossed = most = 0
    chunk = 8192
    for s0 in range(0, o.shape[0], chunk):
        part = (o[s0:s0 + chunk], d[s0:s0 + chunk], t_limit[s0:s0 + chunk])
        hit = gate_hits(scene.tri_saabb, *part)
        n_sb += int(hit.sum())
        n_boxes += int((hit * sizes[None, :]).sum())
        per_ray = gate_hits(scene.tri_aabb, *part).sum(1)
        crossed += int(per_ray.sum())
        most = max(most, int(per_ray.max()))
    return n_sb, crossed, most, OPS_BOX * (o.shape[0] * len(scene.sb_sizes) + n_boxes)


def gate_note(name, label, scene, n_sent, n_rays, n_sb, crossed, most, gate_ops, dev_ms):
    """The streamed kernels' part of a line, also kept with the results:
    `n_sent` rays went to the kernel, the gate's counts are over `n_rays` of
    them."""
    results[name][label].update(
        device_ms=dev_ms, superblocks_per_ray=n_sb / max(n_rays, 1),
        blocks_per_ray=crossed / max(n_rays, 1), most_blocks=most, gate_ops=gate_ops,
        rays_per_warp=kernels.rays_per_warp(n_sent))
    alone = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"  on the device alone {alone}; {kernels.rays_per_warp(n_sent)} rays per warp; per ray "
        f"{n_sb / max(n_rays, 1):.2f} of {len(scene.sb_sizes)} superblocks and "
        f"{crossed / max(n_rays, 1):.2f} of {scene.triangle_blocks} blocks crossed (at most "
        f"{most}); the gate's box tests {gate_ops:.3g} operations "
        f"({gate_ops / PEAK_F32 * 1e3:.4f} ms at the card's peak, not in the bound)")


def check_cast_stream(label, scene, o, d, iters, backface):
    tables = stream_tables(scene)
    kw = dict(backface_culling=backface, sb_sizes=scene.sb_sizes)
    t, i = kernels.cast_triangles_stream(*tables, o, d, **kw)
    torch.cuda.synchronize()
    (t_ref, i_ref), plain = timed_once(
        lambda: kernels.cast_triangles_stream_plain(scene.tri_cast_pack, o, d, backface))
    assert torch.equal(i, i_ref), f"cast_stream {label}: {int((i != i_ref).sum())} indices differ"
    assert torch.equal(t, t_ref), f"cast_stream {label}: t differs by {max_err(t, t_ref)}"
    for _ in range(2):
        t2, i2 = kernels.cast_triangles_stream(*tables, o, d, **kw)
        assert torch.equal(t2, t) and torch.equal(i2, i), f"cast_stream {label}: runs differ"
    ms = cuda_ms(lambda: kernels.cast_triangles_stream(*tables, o, d, **kw), iters)
    dev_ms = device_ms(lambda: kernels.cast_triangles_stream(*tables, o, d, **kw), iters)
    n_sb, crossed, most, gate_ops = gate_work(scene, o, d, t)
    # the pair tests this data needs: the rows of every block the segment crosses
    record("cast_triangles_stream", label, o.shape[0], max_err(t, t_ref), ms, plain,
           nbytes(o, d, *tables, t, i), OPS_TRI * scene.tri_block * crossed,
           f"; hits {int(torch.isfinite(t).sum())}")
    gate_note("cast_triangles_stream", label, scene, o.shape[0], o.shape[0], n_sb, crossed, most,
              gate_ops, dev_ms)


def other_form(kernel_fn, n_rays):
    """The result of kernel_fn with the wrappers' other form for n_rays rays
    (one ray per warp, or many)."""
    least = kernels.PACKET_MIN_RAYS
    kernels.PACKET_MIN_RAYS = 0 if kernels.rays_per_warp(n_rays) == 1 else 1 << 30
    try:
        return kernel_fn()
    finally:
        kernels.PACKET_MIN_RAYS = least


def check_occlusion(name, label, scene, kernel_fn, twin_fn, o, d, md, tables, iters,
                    real=None, big_rows=0, streamed=False):
    """An occlusion kernel against its twin: `opq` identical, the sums within
    1e-5 where `opq` is false, the same bits on three runs and, for the
    resident kernel, in its other form. `real` leaves out the shadow rays of
    lanes without a hit: they start at the parking point 1e9, where f32 has
    a spacing of 64, so the ungated twin's pair tests and the kernel's box
    tests both work on noise (the light loop discards their results).
    `streamed`: the streamed kernel, whose gate is printed too."""
    got = kernel_fn()
    torch.cuda.synchronize()
    ref, plain = timed_once(twin_fn)
    (dec, opq, fsub), (dec_ref, opq_ref, fsub_ref) = got, ref
    if real is None:
        real = torch.ones_like(opq_ref)
    n_diff = int(((opq != opq_ref) & real).sum())
    assert n_diff == 0, f"{name} {label}: {n_diff} opq differ"
    free = ~opq_ref & real
    err = max(max_err(dec[free], dec_ref[free]), max_err(fsub[free], fsub_ref[free]))
    assert err <= 1e-5, f"{name} {label}: sums off by {err}"
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(got, kernel_fn())), \
            f"{name} {label}: bits differ from run to run"
    if not streamed:
        assert same_occlusion(got, other_form(kernel_fn, o.shape[0])), \
            f"{name} {label}: forms differ"
    ms = cuda_ms(kernel_fn, iters)
    dev_ms = device_ms(kernel_fn, iters)
    note = (f"; real rays {int(real.sum())}, occluded {int((opq & real).sum())}, partly shaded "
            f"{int(((dec > 0) & free).sum())}")
    if streamed:
        live = free & (md > 0)
        n_sb, crossed, most, gate_ops = gate_work(scene, o[live], d[live], md[live])
        tests, n_live, _, _ = occlusion_tests(scene, o, d, md, opq_ref, real, big_rows, crossed)
        note += f", {n_live} live"
    else:
        tests, n_live, _, crossed = occlusion_tests(scene, o, d, md, opq_ref, real, big_rows)
        note += (f", {crossed / max(n_live, 1):.1f} blocks crossed per live ray; the same bits "
                 f"in both forms")
    record(name, label, o.shape[0], err, ms, plain, nbytes(o, d, md, *tables, *got),
           OPS_OCCL * tests, note)
    if streamed:
        gate_note(name, label, scene, o.shape[0], n_live, n_sb, crossed, most, gate_ops, dev_ms)
    else:
        alone(results[name][label], o.shape[0], dev_ms)
    return got


def check_occl_stream(label, scene, o, d, md, iters, backface, real=None):
    tables = stream_tables(scene)
    kw = dict(backface_culling=backface, block_has_trans=scene.block_has_trans)
    return check_occlusion(
        "occlude_triangles_stream", label, scene,
        lambda: kernels.occlude_triangles_stream(*tables, o, d, md, sb_sizes=scene.sb_sizes, **kw),
        lambda: kernels.occlude_triangles_stream_plain(scene.tri_cast_pack, o, d, md, backface),
        o, d, md, tables, iters, real=real, streamed=True)


def check_occl_resident(label, scene, o, d, md, iters, backface, real):
    tables = (scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb)
    kw = dict(backface_culling=backface, bigtri_trans=scene.bigtri_trans,
              block_has_trans=scene.block_has_trans, sb_sizes=scene.sb_sizes)
    return check_occlusion(
        "occlude_triangles", label, scene,
        lambda: kernels.occlude_triangles(*tables, o, d, md, **kw),
        lambda: kernels.occlude_triangles_plain(scene.trb_pack, scene.tri_cast_pack, o, d, md,
                                                backface),
        o, d, md, tables, iters, real=real, big_rows=int((scene.trb_pack[:, 13] != 0).sum()))


# the streamed frame's scene: semesterbild plus a cloud of 120,000 small
# triangles, past the default threshold of 81,920
t0 = time.monotonic()
ds_cloud = renderer.device_scene(build("semesterbild_cloud", cfg))
assert ds_cloud.streaming and ds_cloud.n_triangles > cfg.stream_triangles == 81920
assert 0 < sum(ds_cloud.block_has_trans) < ds_cloud.triangle_blocks
log(f"streamed scene: {ds_cloud.n_triangles} triangle slots in {ds_cloud.triangle_blocks} "
    f"blocks of {ds_cloud.tri_block} ({sum(ds_cloud.block_has_trans)} with transmissive "
    f"triangles), {ds_cloud.n_bigtris} big rows, {ds_cloud.n_lights} lights; built in "
    f"{time.monotonic() - t0:.1f} s")

with phase("stream_kernels"):
    rng = np.random.default_rng(8)
    n_val = 32768
    o_val = torch.from_numpy(rng.uniform(0.0, 10.0, (n_val, 3)).astype(np.float32)).to(DEV)
    d_val = torch.from_numpy(rng.normal(size=(n_val, 3)).astype(np.float32)).to(DEV)
    d_val = normalized(d_val)
    md_val = torch.full((n_val,), 4.0, device=DEV)
    for label, share in (("V", 0.0), ("V_glass", 0.25)):
        val = validation_scene(share)
        check_cast_stream(label, val, o_val, d_val, 5, True)
        check_occl_stream(label, val, o_val, d_val, md_val, 5, True)
        del val

    # the streamed frame's shapes: the primary node of 1080p tile 3 ...
    bf = cfg.backface_culling
    check_cast_stream("R", ds_cloud, o_prim, d_prim, 10, bf)
    (so_R, sd_R, md_R, real_R), = shadow_rays(ds_cloud, cfg, o_prim, d_prim, ones)
    assert so_R.shape[0] == ds_cloud.n_lights * R == 655360
    check_occl_stream("R", ds_cloud, so_R, sd_R, md_R, 5, bf, real_R)
    # ... and one pool iteration: the LIFO top of that tile's first pool
    _, _, refl_p, refr_p = trace._eval_node(ds_cloud, cfg, eps, o_prim, d_prim,
                                            *prim_state(R).values(), ones)
    pix64 = torch.arange(R, dtype=torch.int64, device=DEV)
    rows_s = torch.cat([trace._pack_entry(p, pix64) for p in (refr_p, refl_p)])
    rows_s = rows_s[torch.cat([refr_p["mask"], refl_p["mask"]])]
    assert rows_s.shape[0] >= W, rows_s.shape
    e_s = trace._unpack_entry(rows_s[-W:].contiguous())
    o_sw, d_sw = trace._park(e_s["o"], e_s["d"], active)
    check_cast_stream("W", ds_cloud, o_sw.contiguous(), d_sw.contiguous(), 20, bf)
    (so_W, sd_W, md_W, real_W), = shadow_rays(ds_cloud, cfg, e_s["o"], e_s["d"], active)
    assert so_W.shape[0] == ds_cloud.n_lights * W == 10240
    check_occl_stream("W", ds_cloud, so_W, sd_W, md_W, 20, bf, real_W)

    # occlude_triangles: the 655,360 shadow rays of the resident tile, and
    # the 10,240 of its first pool iteration (W rays, 5 lights)
    (so_4, sd_4, md_4, real_4), = shadow_rays(ds, cfg, o_prim, d_prim, ones)
    assert so_4.shape[0] == 655360
    check_occl_resident("R", ds, so_4, sd_4, md_4, 30, bf, real_4)
    (so_4w, sd_4w, md_4w, real_4w), = shadow_rays(ds, cfg, e["o"], e["d"], active)
    assert so_4w.shape[0] == 10240
    check_occl_resident("W", ds, so_4w, sd_4w, md_4w, 100, bf, real_4w)
    # its main path is the entry point itself: one call, counted from zero,
    # held against the pack-level scan of the light kernels' twin
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    opq_e, opacity_e, filter_e = occlude_rays(ds, so_4, sd_4, md_4, bf)
    torch.cuda.synchronize()
    entry_launches = dict(kernels.LAUNCHES)
    assert {k for k, v in entry_launches.items() if v} == {"occlude_triangles"}, entry_launches
    opq_p, opacity_p, filter_p = occlude_packs(ds.sph_pack, ds.trb_pack, ds.tri_blk_pack,
                                                  so_4, sd_4, md_4, bf)
    assert torch.equal(opq_e[real_4], opq_p[real_4])
    free_4 = ~opq_p & real_4
    err_e = max(max_err(opacity_e[free_4], opacity_p[free_4]),
                max_err(filter_e[free_4], filter_p[free_4]))
    assert err_e <= 1e-5, err_e
    log(f"occlude_rays(scene, ...) on {so_4.shape[0]} rays: launches {entry_launches}, "
        f"occluded {int((opq_e & real_4).sum())} of {int(real_4.sum())} real rays, "
        f"max |entry - pack-level twin| {err_e:.3g}")


# ---- phase 2c: block partitions that the JAX package takes ---------------
# (harness.PARTITIONS): more than 32 Morton blocks in one superblock (rounds
# of 32 lanes), and blocks of 48 rows (a ragged last round of rows)


def partition_scene(name, w, h, feats, edge_sigma):
    """(config, host scene) of semesterbild plus a cloud of 2400 small
    triangles, a quarter of them glass, at one of PARTITIONS."""
    c = RenderConfig(width=w, height=h, **MAIN, **feats, **PARTITIONS[name])
    return c, build_cloud(c, n=2400, edge_sigma=edge_sigma, glass_share=0.25)


def check_partition(name):
    """The five kernels with a warp per ray and shade_eval on the primary
    rays of tile 3 (W of them: one ray per warp; R: many per warp) of a
    partition scene, against their twins: both casts' t and index
    identical, both occlusions' `opq` identical on the shadow rays of lanes
    that hit (sums within 1e-5 where it is false; the resident one's bits
    the same in both forms), shade_eval_rows within the traced-colour bar
    and shade_eval bit for bit equal to it in both forms."""
    c, host = partition_scene(name, 1920, 1080, REALISTIC, 0.006)
    ds_p = RaytracerRenderer(c, device="cuda").device_scene(host)
    assert not ds_p.streaming and ds_p.tri_block == PARTITIONS[name]["triangle_block"]
    assert (max(ds_p.sb_sizes) > 32) == (name == "superblock64"), ds_p.sb_sizes
    tables = (ds_p.tri_cast_pack, ds_p.tri_aabb, ds_p.tri_saabb)
    bf = c.backface_culling
    for n in (W, R):
        o, d = o_prim[:n].contiguous(), d_prim[:n].contiguous()
        t, i = kernels.cast_triangles(ds_p.trb_pack, *tables, o, d, sb_sizes=ds_p.sb_sizes,
                                      backface_culling=bf)
        t_ref, i_ref = kernels.cast_triangles_plain(ds_p.trb_pack, tables[0], o, d, bf)
        assert torch.equal(i, i_ref) and same_bits(t, t_ref), f"{name} cast at {n}"
        t, i = kernels.cast_triangles_stream(*tables, o, d, sb_sizes=ds_p.sb_sizes,
                                             backface_culling=bf)
        t_ref, i_ref = kernels.cast_triangles_stream_plain(tables[0], o, d, bf)
        assert torch.equal(i, i_ref) and same_bits(t, t_ref), f"{name} streamed cast at {n}"
        (so, sd, md, real), = shadow_rays(ds_p, c, o, d, ones[:n])
        dec, opq, fsub = kernels.occlude_triangles_stream(
            *tables, so, sd, md, sb_sizes=ds_p.sb_sizes, backface_culling=bf,
            block_has_trans=ds_p.block_has_trans)
        dec_r, opq_r, fsub_r = kernels.occlude_triangles_stream_plain(tables[0], so, sd, md, bf)
        assert torch.equal(opq[real], opq_r[real]), f"{name} occlusion at {n}"
        free = ~opq_r & real
        assert max(max_err(dec[free], dec_r[free]), max_err(fsub[free], fsub_r[free])) <= 1e-5
        # the resident occlusion on the same shadow rays: the big rows, then
        # the same blocks; both forms
        occl = lambda: kernels.occlude_triangles(  # noqa: E731
            ds_p.trb_pack, *tables, so, sd, md, sb_sizes=ds_p.sb_sizes, backface_culling=bf,
            bigtri_trans=ds_p.bigtri_trans, block_has_trans=ds_p.block_has_trans)
        got4 = occl()
        dec_r, opq_r, fsub_r = kernels.occlude_triangles_plain(ds_p.trb_pack, tables[0], so, sd,
                                                               md, bf)
        assert torch.equal(got4[1][real], opq_r[real]), f"{name} resident occlusion at {n}"
        free = ~opq_r & real
        assert max(max_err(got4[0][free], dec_r[free]),
                   max_err(got4[2][free], fsub_r[free])) <= 1e-5
        assert same_occlusion(got4, other_form(occl, so.shape[0])), f"{name} occlusion forms at {n}"
        args = shade_args(ds_p, c, o, d, ones[:n], **prim_state(n))
        kw = shade_kw(ds_p, c)
        pix = torch.arange(n, dtype=torch.int32, device=DEV)
        rows_out = kernels.shade_eval_rows(*args, pix, **kw)
        ref = kernels.shade_eval_rows_plain(*args, pix, **kw)
        assert torch.equal(rows_out[2], ref[2]) and torch.equal(rows_out[4], ref[4]), name
        close(f"shade_eval_rows {name} at {n}", [
            (rows_out[0], ref[0]), (rows_out[1][ref[2]], ref[1][ref[2]]),
            (rows_out[3][ref[4]], ref[3][ref[4]])])
        node_forms_bits(f"{name} at {n}", args, kw)
        log(f"partition {name}: {ds_p.triangle_blocks} blocks of {ds_p.tri_block}, superblocks "
            f"of up to {max(ds_p.sb_sizes)}; at {n} rays: both casts identical to their twins "
            f"({int(torch.isfinite(t).sum())} Morton hits), both occlusions' opq identical on "
            f"{int(real.sum())} real shadow rays ({int((opq & real).sum())} occluded; the "
            f"resident one {int((got4[1] & real).sum())}, its forms bit-identical), "
            f"shade_eval_rows within its bar, shade_eval bit-identical to it in both forms")


with phase("partitions"):
    for part in PARTITIONS:
        check_partition(part)


frames = {}
# u32 checksums of the warm frames on an H100, the same in every run so far:
# every f32 sum on these paths has one order (sorted commit, no atomics)
CHECKSUMS = {
    "realistic": "2f1bddf34a353be8", "default": "07ce4f9c48a3ac65",
    "anti_aliasing": "669b1b29c139c6e7", "soft_shadows": "daf24ebea78bbc88",
    "stack": "ee4a32cb7f8eaad1", "unpacked": "f131f2f6a579ad51",
    "streamed": "af79d8e0ae102406",
    "reference_default": "6f012f95790a4c8d", "extreme": "962119403fd43461",
    "packet": "193430b34cf57603", "packet_small": "400690930b921403",
    # the Morton resort moves f32 sums by too little to change a u8 pixel
    "resort": "2f1bddf34a353be8",
}


def frame_phase(label, c, r, scene, expect):
    """Warm frame of one path: the kernels in `expect` launched, every other
    kernel not launched, dropped == 0, the warm-up frame's checksum."""
    fb0, wall0, _, _ = run_frame(r, scene)  # warm-up (allocator, caches)
    fb, wall, launches, dropped = run_frame(r, scene)
    assert checksum(fb0) == checksum(fb), f"{label}: the warm-up frame differs"
    valid = float((fb != 0).mean())
    left = note_unfinished(label, r)
    log(f"{label} ({c.width}x{c.height}): warm frame {wall * 1e3:.1f} ms, launches {launches}, "
        f"dropped {dropped}, unfinished {left}, valid {valid:.4f}, u32 sha256 {checksum(fb)}")
    assert fb.shape == (c.width * c.height,)
    for k, v in launches.items():
        assert (v > 0) == (k in expect), (label, launches)
    assert dropped == 0, dropped
    assert valid > 0.5, valid
    assert checksum(fb) == CHECKSUMS[label], (label, checksum(fb), CHECKSUMS[label])
    frames[label] = dict(size=f"{c.width}x{c.height}", wall_ms=wall * 1e3, launches=launches,
                         dropped=dropped, unfinished=left, checksum=checksum(fb),
                         valid_share=valid, wall_ms_first=wall0 * 1e3)
    return fb, wall


# ---- phase 3: the 1080p realistic frame (packed-row pool path) -----------
with phase("realistic"):
    fb1, _ = frame_phase("realistic", cfg, renderer, ds, ("cast_triangles", "shade_eval_rows"))

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
def node_launch_ms(prof, node_kernel):
    """Device ms of each call of the wrapper `node_kernel` in a trace, in
    order: the kernels this repository launched for it (shade_eval: the live
    list, then each form)."""
    parts = {"shade_eval": ("::live_slots_kernel", "::shade_eval_warp_kernel",
                            "::shade_eval_lane_kernel")}.get(node_kernel,
                                                             (f"::{node_kernel}_kernel",))
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and any(k in e.name for k in parts)),
                 key=lambda e: e.time_range.start)
    calls = []
    for e in evs:
        if parts[0] in e.name:  # a call's first kernel
            calls.append(0.0)
        calls[-1] += e.time_range.elapsed_us() / 1e3
    return calls


def profile_tile(label, scene, node_kernel, c=cfg, k=3, aa=False):
    """Tile k of config c's frame on `scene` (with `aa`, its AA samples),
    traced: host wall against the device's busy time (the union of its
    operations' intervals);
    `node_kernel` is launched once per node evaluation, and the device time
    of each of its calls is kept."""
    run = tile_call(scene, c, k, aa=aa)
    run()  # warm: on a key new to the stream the pool's first chunk runs eagerly,
    run()  # the next is captured, so the traced run replays
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        tile_wall = (time.monotonic() - t0) * 1e3
    nodes = kernels.LAUNCHES[node_kernel]
    avg = prof.key_averages()
    busy = device_busy_ms(prof.events())
    n_launch = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:6]
    per_call = node_launch_ms(prof, node_kernel)
    log(f"{label} tile {k} traced ({c.width}x{c.height}): wall {tile_wall:.1f} ms, {nodes} node "
        f"evaluations, device busy {busy:.1f} ms "
        f"({'not measured' if busy == 0 else f'idle {1 - busy / tile_wall:.1%}'}), "
        f"{n_launch} kernel launches ({n_launch / nodes:.0f} per node evaluation); "
        f"{node_kernel} {sum(per_call):.3f} ms in {len(per_call)} calls")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms device  x{e.count:<6d} {e.key[:70]}")
    return dict(
        wall_ms=tile_wall, iterations=nodes - 1, device_busy_ms=busy, launches=n_launch,
        node_kernel_ms=per_call,
        top=[dict(key=e.key, device_ms=e.self_device_time_total / 1e3, count=e.count)
             for e in top],
    )


with phase("profile"):
    report["tile_profile"] = profile_tile("realistic", ds, "shade_eval_rows")
    # the stack path: tile 1, whose wavefronts phase 2 caught (live rays)
    prof_stack = profile_tile("stack", ds_stack, "shade_eval", cfg_stack, 1)
    assert len(prof_stack["node_kernel_ms"]) == len(stack_live), prof_stack["node_kernel_ms"]
    log("  shade_eval per wavefront, live rays: device ms " + ", ".join(
        f"{n}: {ms:.4f}" for n, ms in zip(stack_live, prof_stack["node_kernel_ms"])))
    report["tile_profile_stack"] = prof_stack
    c_soft = RenderConfig(width=1920, height=1080, **MAIN, **LIGHTING["soft_shadows"])
    report["tile_profile_soft_shadows"] = profile_tile(
        "soft_shadows", scenes["soft_shadows"], "light_shade", c_soft, 3)

# ---- the CPU twins' frames of phases 5-7, in a process of their own ------
# They take minutes of the host's CPU, the card's phases one core: a process
# renders them while the card runs phases 4 to 6. It starts after phase 3,
# whose one-device walls the mesh phase compares with, and ends before it.
# phase 5: small frames of every path
SMALL = {
    "realistic": (240, 135, REALISTIC),
    "unpacked": (240, 135, dict(REALISTIC, packed_stage=False)),
    "stack": (120, 68, dict(REALISTIC, compaction_ratio=1)),
    "default": (240, 135, LIGHTING["default"]),
    "anti_aliasing": (120, 68, LIGHTING["anti_aliasing"]),
    "soft_shadows": (120, 68, LIGHTING["soft_shadows"]),
    # forced past the threshold: the plain node over the streamed kernels
    "streamed": (240, 135, dict(REALISTIC, stream_triangles=1)),
    # the cloud scene at the two partitions, the pool path: their CPU twins
    # walk 52-78 blocks per node, so these frames are the smallest
    "superblock64": (120, 68, REALISTIC),
    "block48": (64, 48, REALISTIC),
}
# card against the CPU twins at these flags: the pool path at a width the
# twins can afford (their shadow scans test every light against every row)
TWIN_SMALL = dict(kernel_ray_tile=64, compaction_ratio=8, loop_chunk=8)
HQ_SMALL = {"reference_default": (CFG_REF, 40, 30), "extreme": (CFG_EXT, 20, 15)}
# reference_default as the reference's simd_render build (config.py
# packet_mode): 16 AA lanes a pixel (two packets of 8, no dedupe), 133 tiles
# of 131,072 rays, every node through the plain node (cast_triangles, then
# light_shade with 95 lights, then the packet reductions in PyTorch)
CFG_PKT = dataclasses.replace(CFG_REF, packet_mode=True, aa_packet_lanes=8)
TWIN_DIR = os.path.join(ROOT_DIR, "out", "twins")


def twin_jobs():
    """{label: (config, host scene, whether it streams)} of every frame
    that the card renders beside its CPU twins, in the order of use."""
    jobs = {}
    for label, (w, h, feats) in SMALL.items():
        if label in PARTITIONS:
            c, host = partition_scene(label, w, h, feats, 0.05)
        else:
            c = RenderConfig(width=w, height=h, **dict(MAIN, **feats))
            host = build("semesterbild", c)
        jobs[label] = (c, host, label == "streamed")
    configs = {label: dataclasses.replace(c_hq, width=w, height=h, **TWIN_SMALL)
               for label, (c_hq, w, h) in HQ_SMALL.items()}
    # the packet flags: resident, and on a streamed scene (the plain node
    # over the streamed kernels)
    configs["packet"] = dataclasses.replace(CFG_PKT, width=24, height=18, **TWIN_SMALL)
    configs["packet_streamed"] = dataclasses.replace(
        CFG_PKT, width=12, height=10, stream_triangles=1, **TWIN_SMALL)
    for label, c in configs.items():
        jobs[label] = (c, build("semesterbild", c), label == "packet_streamed")
    return jobs


def start_twins(jobs):
    """The process that renders `jobs` through the CPU twins
    (utils/harness.py::twin_frames), one file each into TWIN_DIR."""
    shutil.rmtree(TWIN_DIR, ignore_errors=True)
    os.makedirs(TWIN_DIR)
    path = os.path.join(TWIN_DIR, "jobs.pkl")
    with open(path, "wb") as f:
        pickle.dump([(label, c, host) for label, (c, host, _) in jobs.items()], f)
    threads = max(1, torch.get_num_threads() - 2)  # the rest for this process
    with open(os.path.join(TWIN_DIR, "process.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness",
             path, str(threads)], cwd=ROOT_DIR, stdout=out, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)  # a phase that fails ends it too
    log(f"CPU twins: {len(jobs)} frames in a process of their own ({threads} torch threads)")
    return proc


def twin_frame(label):
    """(u32 frame, dropped, whether the scene streamed, seconds in the
    twins' process, seconds waited here) of one twin frame."""
    path = os.path.join(TWIN_DIR, f"{label}.npz")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if twin_proc.poll() is not None and not os.path.exists(path):
            with open(os.path.join(TWIN_DIR, "process.log")) as f:
                raise RuntimeError(f"the CPU twins' process ended ({twin_proc.returncode}) "
                                   f"before {label}: {f.read()[-3000:]}")
        time.sleep(0.2)
    with np.load(path) as z:
        return (z["frame"], int(z["dropped"]), bool(z["streaming"]), float(z["seconds"]),
                time.monotonic() - t0)


TWINS = twin_jobs()
twin_proc = start_twins(TWINS)

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
    frame_phase("unpacked", cfg_unpacked, r_unpacked, ds_unpacked,
                ("cast_triangles", "shade_eval"))

# ---- phase 4b: the streamed frame at full width ---------------------------
with phase("streamed"):
    STREAMED = ("cast_triangles_stream", "occlude_triangles_stream")
    frame_phase("streamed", cfg, renderer, ds_cloud, STREAMED)
    n_nodes = frames["streamed"]["launches"]["cast_triangles_stream"]
    assert frames["streamed"]["launches"]["occlude_triangles_stream"] == n_nodes
    # which primary rays see the cloud (outside the counted frames)
    first = ds_cloud.sphere_slots + ds_cloud.n_bigtris
    cloud_hits = 0
    for k in range(plan.n_tiles):
        o_k, d_k = tile_rays(cfg, k)
        hit = cast_rays(ds_cloud, o_k, d_k, cfg.backface_culling)
        cloud_hits += int((hit.valid & (hit.obj_idx >= first)).sum())
    cloud_share = cloud_hits / (plan.n_tiles * R)
    assert 0.02 < cloud_share < 0.9, cloud_share
    frames["streamed"].update(pool_iterations=n_nodes - plan.n_tiles, cloud_share=cloud_share)
    log(f"streamed: {n_nodes - plan.n_tiles} pool iterations in {plan.n_tiles} tiles; "
        f"{cloud_share:.4f} of the primary rays hit the cloud")
    report["tile_profile_streamed"] = profile_tile("streamed", ds_cloud, "cast_triangles_stream")


def linear(f):
    return np.stack([(f >> s) & 0xFF for s in (16, 8, 0)], -1).astype(np.float32) / 255.0


def phase5_bar(label, a, b):
    """Two u32 frames within phase 5's bar: under 0.5% of pixels off by more
    than 2e-3 in linear colour, `valid` different at under 0.5%. Returns
    (pixels off, valid differences)."""
    off = int((np.abs(linear(a) - linear(b)).max(-1) > 2e-3).sum())
    valid_diff = int(((a != 0) != (b != 0)).sum())
    assert off < 0.005 * a.size and valid_diff < 0.005 * a.size, (label, off, valid_diff)
    return off, valid_diff


# ---- phase 5: small frames, card against the CPU twins --------------------
with phase("card_vs_cpu"):
    report["image_check"] = {}
    for label, (w, h, _) in SMALL.items():
        c, host, streamed = TWINS[label]
        r = RaytracerRenderer(c, device="cuda")
        t0 = time.monotonic()
        scene_small = r.device_scene(host)
        assert scene_small.streaming == streamed
        gpu = r.render_u32(scene_small)
        assert r.last_dropped == 0
        note_unfinished(f"small {label}", r)
        gpu_s = time.monotonic() - t0
        cpu, cpu_dropped, cpu_streamed, cpu_s, waited = twin_frame(label)
        assert cpu_dropped == 0 and cpu_streamed == streamed
        off, valid_diff = phase5_bar(label, gpu, cpu)
        n_px = gpu.size
        log(f"{label} {w}x{h} card vs CPU twins: {off} of {n_px} pixels off by > 2e-3 "
            f"({off / n_px:.4%}), valid differs at {valid_diff} (knife edges); card "
            f"{gpu_s:.1f} s, CPU {cpu_s:.1f} s in the twins' process (waited {waited:.1f} s)")
        assert (gpu != 0).mean() > 0.5, label
        report["image_check"][label] = dict(size=f"{w}x{h}", pixels=n_px, off=off,
                                            valid_diff=valid_diff, cpu_s=cpu_s, waited_s=waited)

# ---- phase 6: the user's entry points at the reference's configurations --
def used(launches):
    return {k: v for k, v in launches.items() if v}


def pool_kernels(launches, n_tiles):
    """The kernels a pool-path frame with many lights launched, after
    checking that each pool iteration's shade_eval_rows took the light-lanes
    form and each tile's prologue (a ray per lane) did not."""
    ll = kernels.LIGHT_LANES_LAUNCHES
    assert launches[ll] == launches["shade_eval_rows"] - n_tiles, (launches, n_tiles)
    return set(used(launches)) - {ll}


def same_image(a, b):
    """Two ImageBuffers with the same `valid` and colour bits."""
    return (np.array_equal(a.valid, b.valid)
            and np.array_equal(a.color.view(np.int32), b.color.view(np.int32)))


PRESETS = {"default": RenderConfig.default_scene, "realistic": RenderConfig.realistic_scene,
           "reference_default": RenderConfig.reference_default}
# the CLI's runs: (scene, preset, width, height; None: the preset's own size)
CLI_RUNS = (("semesterbild", "realistic", None, None), ("test_scene", "default", 384, 320),
            ("test_text", "realistic", 384, 320))
NODE_PATH = ("cast_triangles", "shade_eval_rows")

def card_vs_twins(label):
    """A small frame of TWINS[label] on the card and through the CPU twins,
    on the pool path: phase 5's bar, the same drops."""
    c, host, streamed = TWINS[label]
    r = RaytracerRenderer(c, device="cuda")
    t0 = time.monotonic()
    scene = r.device_scene(host)
    assert scene.streaming == streamed
    gpu = r.render_u32(scene)
    gpu_s, gpu_dropped = time.monotonic() - t0, r.last_dropped
    note_unfinished(f"small {label}", r)
    cpu, cpu_dropped, cpu_streamed, cpu_s, waited = twin_frame(label)
    assert cpu_streamed == streamed
    p_small = plan_frame(c)
    assert p_small.pix_per_tile * p_small.aa >= c.kernel_ray_tile * c.compaction_ratio
    off, valid_diff = phase5_bar(label, gpu, cpu)
    log(f"{label} {c.width}x{c.height} card vs CPU twins (pool path, W = "
        f"{(p_small.pix_per_tile * p_small.aa // c.compaction_ratio) // c.kernel_ray_tile * c.kernel_ray_tile}): "
        f"{off} of {gpu.size} pixels off by > 2e-3, valid differs at {valid_diff}; dropped "
        f"{gpu_dropped} / {cpu_dropped}; card {gpu_s:.1f} s, CPU {cpu_s:.1f} s in the twins' "
        f"process (waited {waited:.1f} s)")
    assert gpu_dropped == cpu_dropped and (gpu != 0).mean() > 0.5, label
    report["image_check"][label] = dict(size=f"{c.width}x{c.height}", pixels=gpu.size, off=off,
                                        valid_diff=valid_diff, cpu_s=cpu_s, waited_s=waited)


with phase("entry_points"):
    # reference_default 1140x950: the f32 frame (host-built rays, f32
    # colours fetched, the AA samples reduced on the host) and the u32 frame
    r_ref = RaytracerRenderer(CFG_REF, device="cuda")
    ds_ref = r_ref.device_scene(build("semesterbild", CFG_REF))
    p_ref = plan_frame(CFG_REF)
    log(f"reference_default {CFG_REF.width}x{CFG_REF.height}: {p_ref.n_tiles} tiles x "
        f"{p_ref.pix_per_tile * p_ref.aa} rays ({p_ref.aa} per pixel), {ds_ref.n_lights} lights, "
        f"blocks of {ds_ref.tri_block}, depths {CFG_REF.reflection_max_depth}/"
        f"{CFG_REF.refraction_max_depth}")
    r_f32 = RaytracerRenderer(dataclasses.replace(CFG_REF, device_encode=False), device="cuda")
    buf_f32, wall_f32, l_f32 = timed_run(lambda: r_f32.render_device(ds_ref))
    fb_ref, wall_u32, l_u32 = timed_run(lambda: r_ref.render_u32(ds_ref))
    buf_u32 = ImageBuffer.from_u32(fb_ref, CFG_REF.width, CFG_REF.height)
    note_unfinished("reference_default f32", r_f32)
    note_unfinished("reference_default", r_ref)
    du8 = np.abs(buf_f32.as_u8().astype(np.int16) - buf_u32.as_u8().astype(np.int16))
    px_off = float((du8.max(-1) > 0).mean())
    log(f"reference_default f32 frame {wall_f32:.1f} s, launches {used(l_f32)}, dropped "
        f"{r_f32.last_dropped}, unfinished {r_f32.last_unfinished}; u32 frame {wall_u32:.1f} s, "
        f"launches {used(l_u32)}, dropped {r_ref.last_dropped}, unfinished "
        f"{r_ref.last_unfinished}, u32 sha256 {checksum(fb_ref)}; valid identical "
        f"{np.array_equal(buf_f32.valid, buf_u32.valid)}, u8 steps apart at most {du8.max()} "
        f"at {px_off:.4%} of pixels")
    assert np.array_equal(buf_f32.valid, buf_u32.valid)
    assert du8.max() <= 1 and px_off < 0.01, (du8.max(), px_off)
    assert (pool_kernels(l_f32, p_ref.n_tiles) == pool_kernels(l_u32, p_ref.n_tiles)
            == set(NODE_PATH)), (l_f32, l_u32)
    assert r_f32.last_dropped == r_ref.last_dropped
    assert checksum(fb_ref) == CHECKSUMS["reference_default"], checksum(fb_ref)
    frames["reference_default"] = dict(
        size=f"{CFG_REF.width}x{CFG_REF.height}", wall_ms_f32=wall_f32 * 1e3,
        wall_ms=wall_u32 * 1e3, launches=l_u32, launches_f32=l_f32, dropped=r_ref.last_dropped,
        dropped_f32=r_f32.last_dropped, unfinished=r_ref.last_unfinished,
        unfinished_f32=r_f32.last_unfinished, checksum=checksum(fb_ref), u8_steps_share=px_off,
        valid_share=float((fb_ref != 0).mean()))

    # extreme 480x270: two u32 frames, one checksum
    r_ext = RaytracerRenderer(CFG_EXT, device="cuda")
    ds_ext = r_ext.device_scene(build("semesterbild", CFG_EXT))
    p_ext = plan_frame(CFG_EXT)
    runs = [timed_run(lambda: r_ext.render_u32(ds_ext)) for _ in range(2)]
    log(f"extreme {CFG_EXT.width}x{CFG_EXT.height}: {p_ext.n_tiles} tiles x "
        f"{p_ext.pix_per_tile * p_ext.aa} rays ({p_ext.aa} per pixel), {ds_ext.n_lights} lights; "
        f"frames {[round(w, 2) for _, w, _ in runs]} s, launches {used(runs[1][2])}, dropped "
        f"{r_ext.last_dropped}, unfinished {note_unfinished('extreme', r_ext)}, u32 sha256 "
        f"{[checksum(fb) for fb, _, _ in runs]}")
    assert checksum(runs[0][0]) == checksum(runs[1][0]) == CHECKSUMS["extreme"]
    assert pool_kernels(runs[1][2], p_ext.n_tiles) == set(NODE_PATH), runs[1][2]
    frames["extreme"] = dict(
        size=f"{CFG_EXT.width}x{CFG_EXT.height}", wall_ms=runs[1][1] * 1e3,
        wall_ms_first=runs[0][1] * 1e3, launches=runs[1][2], dropped=r_ext.last_dropped,
        unfinished=r_ext.last_unfinished,
        checksum=checksum(runs[1][0]), valid_share=float((runs[1][0] != 0).mean()))
    # where a tile's time goes: tile 3 of each, with its AA samples
    report["tile_profile_reference_default"] = profile_tile(
        "reference_default", ds_ref, "shade_eval_rows", CFG_REF, 3, aa=True)
    report["tile_profile_extreme"] = profile_tile("extreme", ds_ext, "shade_eval_rows", CFG_EXT,
                                                  3, aa=True)

    # the CLI in a process of its own: its PNG is this process's frame
    out_dir = (os.path.dirname(os.path.abspath(ARGS.report)) if ARGS.report
               else os.path.join(ROOT_DIR, "out"))
    os.makedirs(out_dir, exist_ok=True)
    report["cli"] = {}
    for scene_name, preset, w, h in CLI_RUNS:
        out = os.path.join(out_dir, f"cli_{scene_name}_{preset}.png")
        size = [] if w is None else ["--width", str(w), "--height", str(h)]
        t0 = time.monotonic()
        run = subprocess.run(
            [sys.executable, "-m", "hslu_i.ba_raytracing.f2501_raytracer_tpu_torch", "--scene",
             scene_name, "--preset", preset, "--out", out, *size],
            cwd=ROOT_DIR, capture_output=True, text=True, timeout=600)
        cli_s = time.monotonic() - t0
        assert run.returncode == 0, run.stderr[-3000:]
        c = dataclasses.replace(PRESETS[preset](width=w, height=h), scene_backface_culling=True)
        r_cli = RaytracerRenderer(c, device="cuda")
        buf, wall, launches = timed_run(lambda: r_cli.render(build(scene_name, c)))
        note_unfinished(f"CLI {scene_name}/{preset}", r_cli)
        png = read_png(out)
        assert np.array_equal(png, buf.as_u8()), f"CLI {scene_name}/{preset}: PNG differs"
        log(f"CLI {scene_name}/{preset} {c.width}x{c.height}: {cli_s:.1f} s in its process; the "
            f"PNG equals this process's frame ({wall:.1f} s, launches {used(launches)}, "
            f"unfinished {r_cli.last_unfinished}, valid {buf.valid.mean():.4f})")
        report["cli"][f"{scene_name}/{preset}"] = dict(
            size=f"{c.width}x{c.height}", process_s=cli_s, wall_ms=wall * 1e3, launches=launches)

    # the progressive path and get_pixel_color on a small reference_default
    c_prog = dataclasses.replace(CFG_REF, width=228, height=190, device_encode=False)
    r_prog = RaytracerRenderer(c_prog, device="cuda")
    ds_prog = r_prog.device_scene(build("semesterbild", c_prog))
    fused, wall_fused, _ = timed_run(lambda: r_prog.render_device(ds_prog))
    seen = []
    prog, wall_prog, l_prog = timed_run(
        lambda: r_prog.render_device(ds_prog, progress=lambda b, f: seen.append(f)))
    assert seen[-1] == 1.0 and len(seen) == plan_frame(c_prog).n_tiles, seen
    assert same_image(fused, prog), "the progressive frame differs from the fused f32 frame"
    note_unfinished("progressive", r_prog)
    log(f"progressive reference_default {c_prog.width}x{c_prog.height}: {len(seen)} tiles, "
        f"{wall_prog:.2f} s (fused f32 {wall_fused:.2f} s), launches {used(l_prog)}; the fused "
        f"frame bit for bit, last fraction {seen[-1]}")
    pixel_err = 0.0
    for x, y in ((114, 95), (30, 40), (200, 20), (60, 170), (170, 120)):
        (col, val), _, l_px = timed_run(lambda: r_prog.get_pixel_color(ds_prog, x, y))
        assert val == bool(fused.valid[y, x]), (x, y)
        pixel_err = max(pixel_err, float(np.abs(col - fused.as_linear()[y, x]).max()))
        assert set(used(l_px)) == {"cast_triangles", "shade_eval"}, l_px
    assert pixel_err <= 1e-6, pixel_err
    log(f"get_pixel_color at five pixels ({plan_frame(c_prog).aa} rays each, launches "
        f"{used(l_px)} for the last): max |pixel - frame| {pixel_err:.3g}")
    report["progressive"] = dict(tiles=len(seen), wall_ms=wall_prog * 1e3,
                                 wall_ms_fused=wall_fused * 1e3, pixel_err=pixel_err)

    # card against the CPU twins at reference_default's and extreme's flags
    for label in HQ_SMALL:
        card_vs_twins(label)

# ---- phase 7: the reference's SIMD build and the pool's knobs -------------
PACKET_PATH = ("cast_triangles", "light_shade")
PKT_SMALL = (228, 190)


with phase("simd_build"):
    r_pkt = RaytracerRenderer(CFG_PKT, device="cuda")
    ds_pkt = r_pkt.device_scene(build("semesterbild", CFG_PKT))
    p_pkt = plan_frame(CFG_PKT)
    assert (p_pkt.aa, p_pkt.n_tiles, p_pkt.pix_per_tile * p_pkt.aa) == (16, 133, 131072), p_pkt
    assert ds_pkt.n_lights == 95
    # a smaller packet frame first (the warm-up; the full frame's repeat is
    # its recorded checksum)
    c_pks = dataclasses.replace(CFG_PKT, width=PKT_SMALL[0], height=PKT_SMALL[1])
    r_pks = RaytracerRenderer(c_pks, device="cuda")
    ds_pks = r_pks.device_scene(build("semesterbild", c_pks))
    small = [timed_run(lambda: r_pks.render_u32(ds_pks))]
    note_unfinished("packet_small", r_pks)
    assert checksum(small[0][0]) == CHECKSUMS["packet_small"], checksum(small[0][0])
    # the full frame, once
    fb_pkt, wall_pkt, l_pkt = timed_run(lambda: r_pkt.render_u32(ds_pkt))
    log(f"SIMD build (reference_default, packet_mode, 16 lanes a pixel) {CFG_PKT.width}x"
        f"{CFG_PKT.height}: {p_pkt.n_tiles} tiles x 131072 rays, {ds_pkt.n_lights} lights; frame "
        f"{wall_pkt:.1f} s, launches {used(l_pkt)}, dropped {r_pkt.last_dropped}, unfinished "
        f"{note_unfinished('packet', r_pkt)}, valid "
        f"{(fb_pkt != 0).mean():.4f}, u32 sha256 {checksum(fb_pkt)}; {PKT_SMALL[0]}x{PKT_SMALL[1]} "
        f"frame {small[0][1]:.2f} s, sha256 {checksum(small[0][0])}")
    assert set(used(l_pkt)) == set(PACKET_PATH), l_pkt
    assert r_pkt.last_dropped == 0 and (fb_pkt != 0).mean() > 0.5
    assert checksum(fb_pkt) == CHECKSUMS["packet"], checksum(fb_pkt)
    # beside the scalar build's frame (phase 6): other AA samples and shared
    # decisions, the same primary hits at the pixel's centre
    scalar_off = int((np.abs(linear(fb_pkt) - linear(fb_ref)).max(-1) > 2e-3).sum())
    log(f"  against the scalar build's u32 frame: {scalar_off} of {fb_pkt.size} pixels differ by "
        f"> 2e-3, valid differs at {int(((fb_pkt != 0) != (fb_ref != 0)).sum())}")
    frames["packet"] = dict(
        size=f"{CFG_PKT.width}x{CFG_PKT.height}", wall_ms=wall_pkt * 1e3, launches=l_pkt,
        dropped=r_pkt.last_dropped, unfinished=r_pkt.last_unfinished, checksum=checksum(fb_pkt),
        valid_share=float((fb_pkt != 0).mean()), small_wall_ms=[w * 1e3 for _, w, _ in small],
        small_checksum=checksum(small[0][0]), scalar_off=scalar_off)
    # where a packet tile's time goes, and light_shade at R and W, 95 lights:
    # the middle tile (the first tiles of the tile-major order lie in the
    # frame's empty top band at 8192 pixels a tile)
    k_pkt = p_pkt.n_tiles // 2
    report["tile_profile_packet"] = profile_tile("packet", ds_pkt, "light_shade", CFG_PKT,
                                                 k_pkt, aa=True)
    assert report["tile_profile_packet"]["iterations"] > 0
    caught = caught_calls(["light_shade"], tile_call(ds_pkt, CFG_PKT, k_pkt, aa=True),
                          2)["light_shade"]
    assert [a[5].shape[0] for a, _ in caught] == [131072, 2048], [a[5].shape for a, _ in caught]
    for (args_l, kw_l), label in zip(caught, ("Rpk", "Wpk")):
        check_light(label, ds_pkt, args_l, 5 if label == "Rpk" else 50, kw_l)

    # the packet flags on the card and through the CPU twins: resident, and
    # on a streamed scene (the plain node over the streamed kernels)
    card_vs_twins("packet")
    card_vs_twins("packet_streamed")
    assert twin_proc.wait(timeout=60) == 0, twin_proc.returncode  # the twins' last frame

    # the pool's knobs at 1080p realistic: the same frame (the port takes
    # one row scatter and one commit per chunk whatever they say)
    knobs = {}
    for knob in (dict(stage_mode="gather", commit_splits=2),
                 dict(stage_mode="unique", commit_splits=8)):
        r_k = RaytracerRenderer(dataclasses.replace(cfg, **knob), device="cuda")
        fb, wall, launches = timed_run(lambda: r_k.render_u32(ds))
        name = ",".join(f"{k}={v}" for k, v in knob.items())
        knobs[name] = dict(wall_ms=wall * 1e3, checksum=checksum(fb))
        log(f"realistic 1080p {name}: {wall * 1e3:.1f} ms, launches {used(launches)}, dropped "
            f"{r_k.last_dropped}, unfinished {note_unfinished(f'realistic {name}', r_k)}, "
            f"u32 sha256 {checksum(fb)}")
        assert checksum(fb) == CHECKSUMS["realistic"] and set(used(launches)) == set(NODE_PATH)
    # the Morton resort: one checksum on two frames, phase 5's bar against
    # the unsorted frame (phase 3)
    r_rs = RaytracerRenderer(dataclasses.replace(cfg, resort_secondary=True), device="cuda")
    resort = [timed_run(lambda: r_rs.render_u32(ds)) for _ in range(2)]
    note_unfinished("resort", r_rs)
    off, valid_diff = phase5_bar("resort", resort[1][0], fb1)
    log(f"realistic 1080p resort_secondary: {[round(w * 1e3, 1) for _, w, _ in resort]} ms, u32 "
        f"sha256 {[checksum(fb) for fb, _, _ in resort]}; against the unsorted frame {off} pixels "
        f"off by > 2e-3, valid differs at {valid_diff}")
    assert checksum(resort[0][0]) == checksum(resort[1][0]) == CHECKSUMS["resort"]
    knobs["resort_secondary"] = dict(wall_ms=[w * 1e3 for _, w, _ in resort],
                                     checksum=checksum(resort[1][0]), off=off)

    # the overlapped fetch: 1080p default with fetch_groups 1 and 8 (taper),
    # in turns 1, 8, 8, 1
    c_def = RenderConfig(width=1920, height=1080, **MAIN, **LIGHTING["default"])
    fetch = {1: [], 8: []}
    for fg in (1, 8, 8, 1):
        r_f = RaytracerRenderer(dataclasses.replace(c_def, fetch_groups=fg), device="cuda")
        fb, wall, _ = timed_run(lambda: r_f.render_u32(scenes["default"]))
        assert checksum(fb) == CHECKSUMS["default"], (fg, checksum(fb))
        note_unfinished(f"default fetch_groups={fg}", r_f)
        fetch[fg].append(wall * 1e3)
    log(f"default 1080p, fetch_groups 1 / 8 (taper, groups {launch_groups(c_def, 16)}) in turns: "
        f"{fetch[1]} / {fetch[8]} ms, one checksum")
    knobs["fetch_groups"] = fetch

    # autotune's triangle_block on the realistic frame's scene
    t0 = time.monotonic()
    tuned = autotune(Scene.backface_culling(build("semesterbild", cfg), np.array([0.0, 0.0, 1.0])),
                     cfg, candidates=(32, 64, 128, 256, 512), verbose=True)
    tune_s = time.monotonic() - t0
    r_t = RaytracerRenderer(tuned.cfg, device="cuda")
    fb_t, wall_t, _ = timed_run(lambda: r_t.render_u32(tuned.device_scene))
    note_unfinished("autotune", r_t)
    off, valid_diff = phase5_bar("autotune", fb_t, fb1)
    log(f"autotune ({tune_s:.1f} s): ms by triangle_block {tuned.timings_ms}, tuned "
        f"{tuned.tuned_block} (the realistic frame's: {ds.tri_block}); tuned frame "
        f"{wall_t * 1e3:.1f} ms, u32 sha256 {checksum(fb_t)}, against the default frame {off} "
        f"pixels off by > 2e-3, valid differs at {valid_diff}")
    knobs["autotune"] = dict(timings_ms=tuned.timings_ms, tuned_block=tuned.tuned_block,
                             seconds=tune_s, wall_ms=wall_t * 1e3, off=off)
    report["knobs"] = knobs

# ---- phase 7b: multi-device rendering on one card -------------------------
# A mesh lists the card k times: k shards with a host thread and a stream
# each, the scene replicated per device (once here), the results joined on
# the lead entry. It measures no scaling: the entries share one card.
def mesh_frame(label, c, devs, scene):
    """Frame `label` (config c) through RaytracerRenderer(devices=len(devs))
    on the mesh `devs`, twice, as `frame_phase` runs a path: the first frame
    on the new renderer's streams (their allocator pools empty), then the
    warm frame, whose wall stands beside the one-device warm wall. Each
    with the one-device frame's checksum and launches, dropped 0."""
    r_m = RaytracerRenderer(dataclasses.replace(c, devices=len(devs)), device=devs)
    one = frames[label]
    walls = []
    for _ in range(2):
        fb, wall, launches = timed_run(lambda: r_m.render_u32(scene))
        assert checksum(fb) == CHECKSUMS[label], (label, checksum(fb))
        assert launches == one["launches"], (label, launches, one["launches"])
        assert r_m.last_dropped == 0
        note_unfinished(f"{label} on {len(devs)} mesh entries", r_m)
        walls.append(wall * 1e3)
    log(f"{label} 1080p on {len(devs)} mesh entries ({', '.join(map(str, devs))}): warm frame "
        f"{walls[1]:.1f} ms (first {walls[0]:.1f} ms) against {one['wall_ms']:.1f} ms warm on one "
        f"device (first {one['wall_ms_first']:.1f} ms; {report['card']}; the entries share one "
        f"card: no scaling is measured); launches {used(launches)}, dropped {r_m.last_dropped}, "
        f"unfinished {r_m.last_unfinished}, "
        f"u32 sha256 {checksum(fb)} both times")
    return dict(entries=[str(x) for x in devs], wall_ms=walls[1], wall_ms_first=walls[0],
                wall_ms_one_device=one["wall_ms"], wall_ms_first_one_device=one["wall_ms_first"],
                launches=launches, checksum=checksum(fb))


with phase("mesh"):
    mesh_report = {}
    one_card = ["cuda:0"]
    # (a) the realistic frame on 2 and 4 entries, the default frame on 4
    for k in (2, 4):
        mesh_report[f"realistic_x{k}"] = mesh_frame("realistic", cfg, one_card * k, ds)
    mesh_report["default_x4"] = mesh_frame("default", c_def, one_card * 4, scenes["default"])
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh_report[f"realistic_cards{n_cards}"] = mesh_frame(
            "realistic", cfg, [f"cuda:{i}" for i in range(n_cards)], ds)
    else:
        # (d) no fallback: a mesh of more cards than the host has is refused
        try:
            RaytracerRenderer(dataclasses.replace(cfg, devices=2))
        except RuntimeError as e:
            refused = str(e)
        else:
            raise AssertionError("RaytracerRenderer(devices=2) on a host with one card")
        log(f"RaytracerRenderer(devices=2) on this one-card host raises: {refused}")
        mesh_report["refused"] = refused

    # (b) the objs axis: cast_nearest_objsharded over 4 entries on the
    # streamed cloud scene, its blocks padded to a multiple of 4, tile 3's
    # primary rays, against the dense cast on one device
    t0 = time.monotonic()
    ds_cloud4 = build_device_scene(
        Scene.backface_culling(build("semesterbild_cloud", cfg), np.array([0.0, 0.0, 1.0])),
        cfg, min_tri_blocks=4, device=DEV)
    assert ds_cloud4.streaming and ds_cloud4.triangle_blocks % 4 == 0
    build_s = time.monotonic() - t0
    mesh4 = parallel.make_mesh(devices=one_card * 4, axis="objs")
    bf = cfg.backface_culling
    (t_s, idx_s, valid_s), wall_s, launches_s = timed_run(
        lambda: parallel.cast_nearest_objsharded(ds_cloud4, o_prim, d_prim, mesh4, bf))
    hit = cast_rays(ds_cloud4, o_prim, d_prim, bf)
    torch.cuda.synchronize()
    assert used(launches_s) == {"cast_triangles_stream": 4}, launches_s
    assert torch.equal(valid_s, hit.valid) and torch.equal(idx_s[valid_s], hit.obj_idx[valid_s])
    t_err = float(((t_s - hit.t).abs() / hit.t.abs())[valid_s].max())
    assert t_err <= 1e-6, t_err
    first = ds_cloud4.sphere_slots + ds_cloud4.n_bigtris
    runs = ((idx_s[valid_s & (idx_s >= first)] - first) // ds_cloud4.tri_block
            // (ds_cloud4.triangle_blocks // 4)).unique().tolist()
    log(f"objs axis: cast_nearest_objsharded on 4 entries, {ds_cloud4.triangle_blocks} blocks "
        f"(scene built in {build_s:.1f} s), {o_prim.shape[0]} rays: {wall_s * 1e3:.1f} ms, "
        f"launches {used(launches_s)}; valid and object index those of the dense cast, t within "
        f"{t_err:.3g} relative; hits in the block runs of entries {runs}")
    mesh_report["objs_cast"] = dict(blocks=ds_cloud4.triangle_blocks, rays=o_prim.shape[0],
                                    wall_ms=wall_s * 1e3, launches=launches_s, t_rel_err=t_err,
                                    entries_hit=runs)
    del ds_cloud4

    # (c) the rays axis on one 1080p tile (tile 3) over 4 entries: the
    # lighting-only tile traces each ray alone, so render_image_sharded and
    # the joined trace_rays_sharded have trace_rays' bits; a realistic tile's
    # shares take the pool at their own width, whose service order moves the
    # f32 sums by rounding (parallel/mesh.py): tests/test_multichip.py's bar
    mesh_rays = parallel.make_mesh(devices=one_card * 4)
    o_d, d_d = tile_rays(c_def, 3)
    c1, v1 = trace.trace_rays(scenes["default"], c_def, o_d, d_d)
    cm, vm = parallel.render_image_sharded(scenes["default"], c_def, o_d, d_d, mesh_rays)
    shards = parallel.trace_rays_sharded(scenes["default"], c_def, o_d, d_d, mesh_rays)
    torch.cuda.synchronize()
    assert same_bits(cm, c1) and torch.equal(vm, v1), "default tile: not trace_rays' bits"
    assert len(shards) == 4 and all(c.device == torch.device("cuda", 0) for c, _ in shards)
    assert same_bits(torch.cat([c for c, _ in shards]), c1)
    assert torch.equal(torch.cat([v for _, v in shards]), v1)
    c1, v1 = trace.trace_rays(ds, cfg, o_prim, d_prim)
    cm, vm = parallel.render_image_sharded(ds, cfg, o_prim, d_prim, mesh_rays)
    torch.cuda.synchronize()
    n_moved = int((cm != c1).any(-1).sum())
    tile_err = float((cm - c1).abs().max())
    assert torch.equal(vm, v1) and torch.allclose(cm, c1, rtol=1e-5, atol=1e-6), tile_err
    log(f"rays axis, tile 3 on 4 entries: default tile ({o_d.shape[0]} rays) trace_rays' bits "
        f"(joined and in shards); realistic tile valid identical, {n_moved} rays' colours "
        f"moved by rounding, at most {tile_err:.3g}")
    mesh_report["rays_axis"] = dict(default_bits=True, realistic_rays_moved=n_moved,
                                    realistic_max_err=tile_err)
    report["mesh"] = mesh_report
    # the main path's launches on a mesh: the 4-entry frames and the cast
    launches_mesh = dict(mesh_report["realistic_x4"]["launches"])
    launches_mesh["light_shade"] = mesh_report["default_x4"]["launches"]["light_shade"]
    launches_mesh["cast_triangles_stream"] = launches_s["cast_triangles_stream"]
    for name in ("cast_triangles", "shade_eval_rows", "light_shade", "cast_triangles_stream"):
        assert launches_mesh[name] > 0, name

# ---- phase 8: results ----------------------------------------------------
# each kernel's launches: from the path it serves (the frame of phase 3/4)
frames["occlude_rays"] = dict(launches=entry_launches)
# every frame's rays left untraced at the iteration cap: 0, but for the open
# faults of UNFINISHED_OPEN (ROADMAP.md Queue 3), each at its count
report["unfinished"] = unfinished
log(f"unfinished rays by frame: {json.dumps(unfinished)}")
for label, n_left in unfinished.items():
    assert n_left == UNFINISHED_OPEN.get(label, 0), (label, n_left)
# name: (source, line of the TPU kernel body, path whose run gives the
# launches, label of the main measurement, labels of the others)
ENTRIES = {
    "cast_triangles": ("cast_triangles.cu", 301, "realistic", "R", ["W"]),
    "cast_triangles_stream": ("cast_triangles_stream.cu", 473, "streamed", "R",
                              ["W", "V", "V_glass"]),
    "occlude_triangles_stream": ("occlude_triangles_stream.cu", 604, "streamed", "R",
                                 ["W", "V", "V_glass"]),
    "occlude_triangles": ("occlude_triangles.cu", 964, "occlude_rays", "R", ["W"]),
    "shade_eval_rows": ("shade_eval_rows.cu", 1858, "realistic", "R",
                        ["W", "R95", "W95", "R140", "W140"]),
    "light_shade": ("light_shade.cu", 1834, "default", "R", ["R_soft", "Rpk", "Wpk"]),
    "shade_eval": ("shade_eval.cu", 1858, "stack", "R", ["S", "W", "S95"]),
}
EXTRA = {"W": "pool", "R_soft": "soft", "V": "validation", "V_glass": "validation_glass",
         "S": "sparse", "R95": "hq95", "W95": "hq95_pool", "R140": "extreme",
         "W140": "extreme_pool", "S95": "hq95_sparse", "Rpk": "packet", "Wpk": "packet_pool"}
assert set(ENTRIES) == set(kernels.KERNEL_SOURCES)
line = []
for name, (src, tpu_line, path, main, others) in ENTRIES.items():
    m = results[name][main]
    launches = frames[path]["launches"][name]
    assert launches > 0, f"{name} was not launched on its path ({path})"
    entry = dict(
        name=name, route="cuda", source=f"{PKG}/csrc/{src}",
        replaces=f"{TPU_KERNELS}:{tpu_line}", launches=launches,
        max_abs_err=max(v["err"] for v in results[name].values()), ms=m["ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=None, launches_path=path, rays=m["R"],
        launches_packet=frames["packet"]["launches"][name],
    )
    if name in ("cast_triangles", "cast_triangles_stream", "shade_eval_rows", "light_shade"):
        entry["launches_mesh"] = launches_mesh[name]
    for label in others:
        o_res = results[name][label]
        sfx = EXTRA[label]
        entry.update({f"ms_{sfx}": o_res["ms"], f"plain_ms_{sfx}": o_res["plain_ms"],
                      f"bound_ms_{sfx}": o_res["bound_ms"], f"bound_by_{sfx}": o_res["bound_by"],
                      f"rays_{sfx}": o_res["R"]})
    if name in TIMED_KERNELS:
        entry.update(registers=report["ptxas"][name]["forms"],
                     spill_bytes=report["ptxas"][name]["spill_bytes"],
                     registers_cached=report["ptxas"][name]["cached"])
        for label in [main, *others]:
            sfx = "" if label == main else "_" + EXTRA[label]
            entry.update({k + sfx: v for k, v in results[name][label].items() if k in
                          ("device_ms", "superblocks_per_ray", "blocks_per_ray", "most_blocks",
                           "gate_ops", "rays_per_warp", "live", "form")})
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
