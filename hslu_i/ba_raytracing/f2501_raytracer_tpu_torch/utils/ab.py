"""Side measurements of the port on one NVIDIA GPU, kept out of
chip_smoke.py. Each run measures the package of one checkout, so that two
trees can take turns within one run (parent, change, change, parent): walls
and kernel times differ more between machines than between trees. Run as a
file from anywhere:

    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        frames N [--scene semesterbild semesterbild_cloud] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        kernels [--scene semesterbild semesterbild_cloud occlusion] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        shading [--switches] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        forms [--scene semesterbild semesterbild_cloud occlusion]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        sass [--kernel NAME] [--out PATH]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        cli [--preset NAME] [--out PATH] [--root DIR]

frames N   render the 1920x1080 `realistic` frame (chip_smoke.py's settings)
           of each scene named: `semesterbild` (the resident packed-row pool
           path, through cast_triangles and shade_eval_rows) and
           `semesterbild_cloud` (the streamed path); once to warm up and N
           times more; print each wall time, the launches and the u32
           checksum.
kernels    the two kernels of each scene's path (`semesterbild`:
           cast_triangles and shade_eval_rows; `semesterbild_cloud`:
           cast_triangles_stream and occlude_triangles_stream) at the
           primary node of tile 3 of the 1080p `realistic` frame (R) and at
           that tile's first pool iteration (W), both caught from a render:
           the time on the device alone (torch.profiler, the mean over 20
           calls at R and 100 at W, or over the launches a trace caught)
           and of the wrapper by CUDA events; before
           them, tile 3 traced with torch.profiler (device busy time,
           launches per node evaluation); first, the registers per thread
           that ptxas gave the kernels' build. `occlusion` (not a frame's
           scene; not taken by default): occlude_triangles, the resident
           occlusion, at the three widths of its callers on four resident
           scenes (see OCCLUSION_SCENES). The widths are the shadow rays of
           the port's light loop: 10,240 from the first pool iteration of
           the 1080p `realistic` frame's tile 3 (5 lights x W = 2048),
           655,360 from that tile's primary rays (5 lights x R = 131072)
           and 2,097,152 from the same rays under `soft_shadows` (the
           light loop's first chunk of 16 of its 50 lights). Each: the time
           on the device alone and by CUDA events, the bound as
           chip_smoke.py counts it and a hash of the results (`opq` and the
           sums where it is false), which two trees must share.
shading    the two shading kernels off the main path at every shape they
           run, caught from renders: shade_eval at every wavefront of tile
           1 of the 960x540 stack-path frame (its live rays, valid != 0,
           beside each) and at the first pool iteration of the 240x135
           `packed_stage=False` frame (W = 512); light_shade at tile 3 of
           the 1080p `default` (5 lights) and `soft_shadows` (50 lights)
           frames. Each: the time on the device alone (all of a call's
           kernels) and of the wrapper by CUDA events; first, the registers.
           With --switches, instead: the shadow scan's switches
           (kernels.PRIME_GATE, SORT_GATE) as the variable, in turns off,
           prime, sort, both, both, sort, prime, off, at the points where
           they can act: light_shade at 95 lights and W = 2048 (tile 66 of
           the SIMD build, reference_default with packet_mode), at 50
           lights and R = 131072 (tile 3 of 1080p `soft_shadows`);
           shade_eval_rows at 140 lights and W = 3584 (tile 3 of 480x270
           `extreme`); and on the 235-block cloud (semesterbild plus
           15,000 small triangles in blocks of 64) at 50 lights,
           light_shade at R (tile 3 of `soft_shadows`) and shade_eval_rows
           at R and W (tile 3 of `soft_shadows` with `realistic`'s
           children). Each: whether each switch acts, the time on the
           device alone per setting, the same bits under all four (this
           tree only: a parent without the switches times four times the
           same kernel), and where the lit shadow rays' scans end: at an
           opaque sphere or big primitive, in an opaque Morton block (the
           only ends that the switches can bring forward), or at none.
forms      the kernels with a warp per ray, with one ray per warp and with
           many, in turns one, many, many, one, for each scene named: on
           `semesterbild` cast_triangles and shade_eval_rows (a ray per
           lane) at W and at R, then shade_eval's two forms at every
           wavefront of the stack tile and at W = 512, against its live
           rays (what `kernels.NODE_WARP_MAX_LIVE` decides between); on
           `semesterbild_cloud` the two streamed kernels (eight rays per
           warp) at the pool's width (2048 rays and 10,240 shadow rays);
           with `occlusion`, occlude_triangles (a ray per lane) on the
           cases of `kernels`. `kernels.PACKET_MIN_RAYS` decides between
           one and many. The results must be the same.
sass       the machine code of one kernel's build (cuobjdump -sass) into
           PATH (default: sass_NAME.txt beside the built library); printed:
           for each kernel function (each form) its instructions, and for
           each of its loops (a backward branch) the instructions of the
           span, its shared and global loads, f32 arithmetic (FADD, FMUL,
           FFMA, FSETP, FSEL, FMNMX, FCHK), MUFU and branches: what one pass
           of a pair test's loop issues.
cli        the package's CLI (`python -m ...f2501_raytracer_tpu_torch`) in a
           process of its own: semesterbild under `--preset` (default
           reference_default) at the preset's own size and the CLI's
           defaults (tile_rays 8192, the f32 frame path), its PNG into
           PATH (default: out/ of checkout DIR); printed: the process's
           wall, the render's own elapsed time (the CLI's `RenderTiming`
           line) and the PNG's hash.
--root DIR imports the package from another checkout (one unpacked with
           `git archive`).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import re
import subprocess
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("what", choices=("frames", "kernels", "shading", "forms", "sass", "cli"))
parser.add_argument("n", type=int, nargs="?", default=2, help="frames: warm frames per scene")
parser.add_argument("--scene", nargs="+",
                    choices=("semesterbild", "semesterbild_cloud", "occlusion"),
                    default=["semesterbild", "semesterbild_cloud"])
parser.add_argument("--kernel", default="occlude_triangles", help="sass: the kernel")
parser.add_argument("--switches", action="store_true",
                    help="shading: time the shadow scan's switches instead")
parser.add_argument("--out", help="sass: the file for the whole listing; cli: the PNG")
parser.add_argument("--preset", default="reference_default",
                    choices=("default", "realistic", "reference_default"), help="cli: the preset")
parser.add_argument("--root", default=os.path.join(os.path.dirname(__file__), *[".."] * 4),
                    help="the checkout whose package is imported (default: this one)")
ARGS = parser.parse_args()
# the package of checkout ARGS.root; the shared helpers (harness.py) of this
# one, which a parent checkout may lack
sys.path[0:1] = [os.path.abspath(ARGS.root), os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402
from harness import (  # noqa: E402
    GATE_SETTINGS,
    OPS_OCCL,
    PARTITIONS,
    bound_ms,
    caught_calls,
    cuda_ms,
    device_ms,
    flat,
    nbytes,
    occlusion_tests,
    same_bits,
    same_occlusion,
    scan_lengths,
    shadow_rays,
    tile_call,
    with_gates,
)
from timing import device_busy_ms  # noqa: E402 (this checkout's, as harness.py)

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (  # noqa: E402
    RaytracerRenderer,
    RenderConfig,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import (  # noqa: E402
    build,
    triangle_cloud,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import (  # noqa: E402
    occlude_packs,
)

if not torch.cuda.is_available():
    sys.exit("ab.py: no CUDA device available")
# chip_smoke.py's settings (bench.py:222-290)
MAIN = dict(
    scene_backface_culling=True, tile_rays=131072, max_nodes=48, weight_cutoff=1e-3,
    compaction_ratio=64, kernel_ray_tile=512, loop_chunk=96, device_encode=True,
    stage_mode="scatter", commit_splits=1,
)
REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)
# bench.py:49-57's extreme, chip_smoke.py's CFG_EXT
EXTREME = dict(REALISTIC, anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True,
               extreme_quality=True, high_quality_model=True)
cfg = RenderConfig(width=1920, height=1080, **MAIN, **REALISTIC)
renderer = RaytracerRenderer(cfg, device="cuda")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(f"{card}; package from {sys.path[0]}", flush=True)


# the kernels of each scene's path, its node kernel first
KERNELS = {"semesterbild": ("cast_triangles", "shade_eval_rows"),
           "semesterbild_cloud": ("cast_triangles_stream", "occlude_triangles_stream")}


def scene_of(name, c=cfg):
    """The device scene `name` as config c's renderer builds it (c sets the
    block size)."""
    scene = RaytracerRenderer(c, device="cuda").device_scene(build(name, c))
    assert scene.streaming == (name == "semesterbild_cloud")
    return scene


def frames(n):
    for name in ARGS.scene:
        scene = scene_of(name)
        for k in range(n + 1):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            fb = renderer.render_u32(scene)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            assert renderer.last_dropped == 0
            print(f"{name} 1920x1080 frame {k}{' (warm-up)' if k == 0 else ''}: "
                  f"{wall * 1e3:.1f} ms, launches "
                  f"{ {k: v for k, v in kernels.LAUNCHES.items() if v} }, "
                  f"u32 sha256 {hashlib.sha256(fb.tobytes()).hexdigest()[:16]}", flush=True)


def traced_tile(name, scene):
    """Tile 3 traced with torch.profiler, as chip_smoke.py's `profile_tile`:
    host wall, device busy time (the union of the device operations'
    intervals), launches per node evaluation, the kernels that take the most
    device time."""
    run = tile_call(scene, cfg, 3)
    run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    nodes = kernels.LAUNCHES[KERNELS[name][0]]
    avg = prof.key_averages()
    busy = device_busy_ms(prof.events())
    n_launch = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    print(f"{name} tile 3 traced: wall {wall:.1f} ms, {nodes} node evaluations, device busy "
          f"{busy:.2f} ms, {n_launch} kernel launches ({n_launch / nodes:.1f} per node "
          f"evaluation)", flush=True)
    for e in sorted(avg, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms device  x{e.count:<6d} {e.key[:70]}",
              flush=True)


def n_rays(name, a):
    """The ray count of a caught call: the length of its first per-ray argument."""
    return a[5 if name.startswith("shade") else 3 if name.endswith("stream") else 4].shape[0]


def registers():
    built = kernels.build_kernels()
    for name, info in sorted(built.items()):
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", info["ptxas"])]
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", info["ptxas"]))
        print(f"  {name}: registers {regs}, spilled {spill} bytes "
              f"({'a cached build' if info['cached'] else 'this run'})", flush=True)


def kernel_times():
    registers()
    if "occlusion" in ARGS.scene:
        occlusion_times()
    for scene_name in ARGS.scene:
        if scene_name not in KERNELS:
            continue
        scene = scene_of(scene_name)
        traced_tile(scene_name, scene)
        caught = caught_calls(KERNELS[scene_name], tile_call(scene, cfg, 3), 2)
        for name, calls in caught.items():
            wrapper = getattr(kernels, name)
            for label, (a, kw), n in zip(("R", "W"), calls, (20, 100)):
                fn = lambda: wrapper(*a, **kw)  # noqa: E731
                print(f"{name} {label} ({n_rays(name, a)} rays): device "
                      f"{device_ms(fn, n)} ms, wrapper by CUDA events "
                      f"{cuda_ms(fn, n)} ms", flush=True)


def shading_calls(stride=1):
    """(label, wrapper, args, kw) of every shape the two shading kernels run,
    caught from renders (see `shading`); of the stack tile's wavefronts
    the first four and every `stride`-th."""
    out = []
    c = RenderConfig(width=960, height=540, **dict(MAIN, compaction_ratio=1), **REALISTIC)
    scene = scene_of("semesterbild", c)
    calls = caught_calls(["shade_eval"], tile_call(scene, c, 1))["shade_eval"]
    out += [(f"stack 960x540 tile 1 wavefront {i}", kernels.shade_eval, a, kw)
            for i, (a, kw) in enumerate(calls) if i < 4 or i % stride == 0]
    c = RenderConfig(width=240, height=135, **dict(MAIN, packed_stage=False), **REALISTIC)
    scene = scene_of("semesterbild", c)
    calls = caught_calls(["shade_eval"], tile_call(scene, c, 0), 2)["shade_eval"]
    out.append(("unpacked 240x135 first pool iteration", kernels.shade_eval, *calls[1]))
    for name, feats in (("default", {}), ("soft_shadows", dict(soft_shadows=True))):
        c = RenderConfig(width=1920, height=1080, **MAIN, **feats)
        scene = scene_of("semesterbild", c)
        calls = caught_calls(["light_shade"], tile_call(scene, c, 3), 1)["light_shade"]
        out.append((f"{name} 1920x1080 tile 3 ({scene.n_lights} lights)", kernels.light_shade,
                    *calls[0]))
    return out


def live(a):
    """The live rays (valid != 0) of a shading kernel's call."""
    return int((a[10] != 0).sum())


def switch_calls():
    """(label, wrapper, args, kw) of the points of `shading --switches`,
    caught from renders."""
    out = []
    c = dataclasses.replace(RenderConfig.reference_default(
        **{k: v for k, v in MAIN.items() if k != "scene_backface_culling"}),
        packet_mode=True, aa_packet_lanes=8)
    calls = caught_calls(["light_shade"], tile_call(scene_of("semesterbild", c), c, 66, aa=True),
                         2)["light_shade"]
    out.append(("SIMD build 1140x950 tile 66, W", kernels.light_shade, *calls[1]))
    c = RenderConfig(width=1920, height=1080, **MAIN, soft_shadows=True)
    calls = caught_calls(["light_shade"], tile_call(scene_of("semesterbild", c), c, 3),
                         1)["light_shade"]
    out.append(("soft_shadows 1920x1080 tile 3, R", kernels.light_shade, *calls[0]))
    c = RenderConfig(width=480, height=270, **dict(MAIN, tile_rays=262144), **EXTREME)
    calls = caught_calls(["shade_eval_rows"], tile_call(scene_of("semesterbild", c), c, 3,
                                                        aa=True), 2)["shade_eval_rows"]
    out.append(("extreme 480x270 tile 3, W", kernels.shade_eval_rows, *calls[1]))
    for name, feats in (("light_shade", dict(soft_shadows=True)),
                        ("shade_eval_rows", dict(REALISTIC, soft_shadows=True))):
        c = RenderConfig(width=1920, height=1080, **dict(MAIN, triangle_block=64), **feats)
        scene = RaytracerRenderer(c, device="cuda").device_scene(
            triangle_cloud.build_scene(c, n=15000))
        calls = caught_calls([name], tile_call(scene, c, 3), 2)[name]
        for label, (a, kw) in zip(("R", "W"), calls):
            out.append((f"cloud ({scene.tri_blk_pack.shape[0]} blocks) soft_shadows tile 3, "
                        f"{label}", getattr(kernels, name), a, kw))
    return out


def scan_ends(a, kw):
    """Where the shadow scans of a shading call's lit (ray, light) pairs
    end: (pairs, at an opaque sphere or big primitive, at an opaque Morton
    block, at no opaque hit). The switches reorder only the Morton blocks,
    so only the second count can end earlier with them. Counted light by
    light with the plain sphere and big-primitive scan and the streamed
    occlusion kernel over the node pack (a superblock per block)."""
    light_pack, sph, trb, blk, aabb, point, normal = a[:7]
    keep = a[10] != 0
    P, N = point[keep], normal[keep]
    nb = blk.shape[0]
    bf = kw.get("backface_culling", False)
    n_pairs = n_front = n_block = 0
    for li in range(kw["n_lights"]):
        lp = light_pack[li, 0:3]
        lt = lp[None, :] - P
        dist = lt.norm(dim=1)
        lit = (lt * N).sum(1) / dist > 0
        ld = (lt[lit] / dist[lit, None]).contiguous()
        so = (P[lit] + ld * kw["eps_dist"]).contiguous()
        md = (lp[None, :] - so).norm(dim=1).contiguous()
        front = occlude_packs(sph, trb, blk[:0], so, ld, md, bf)[0]
        block = kernels.occlude_triangles_stream(blk, aabb, aabb, so, ld, md, sb_sizes=(1,) * nb,
                                                 backface_culling=bf)[1]
        n_pairs += so.shape[0]
        n_front += int(front.sum())
        n_block += int((block & ~front).sum())
    return n_pairs, n_front, n_block, n_pairs - n_front - n_block


def switches():
    registers()
    names = {(False, False): "off", (True, False): "prime", (False, True): "sort",
             (True, True): "both"}
    for label, wrapper, a, kw in switch_calls():
        acts = with_gates(True, True, lambda: kernels.gate_switches(
            kw["n_lights"], a[3].shape[0], kw["n_trans_blocks"]))
        fn = lambda: wrapper(*a, **kw)  # noqa: E731
        base = flat(with_gates(False, False, fn))
        ms = {v: [] for v in names.values()}
        n = 10 if a[5].shape[0] > 100_000 else 50
        for setting in (*GATE_SETTINGS, *reversed(GATE_SETTINGS)):
            assert all(same_bits(x, y) for x, y in zip(base, flat(with_gates(*setting, fn)))), \
                (label, setting)
            ms[names[setting]].append(with_gates(*setting, lambda: device_ms(fn, n)))
        pairs, front, block, none = scan_ends(a, kw)
        print(f"{wrapper.__name__} {label}: {a[5].shape[0]} rays, {live(a)} live, "
              f"{kw['n_lights']} lights, {a[3].shape[0]} blocks ({kw['n_trans_blocks']} "
              f"transmissive): PRIME acts {acts[0]}, SORT acts {acts[1]}; device ms "
              + ", ".join(f"{k} {v}" for k, v in ms.items()) + "; the same bits; of "
              f"{pairs} lit (ray, light) pairs the scan ends at an opaque sphere or big "
              f"primitive for {front}, in an opaque Morton block for {block}, at no opaque "
              f"hit for {none}", flush=True)


def shading():
    if ARGS.switches:
        return switches()
    registers()
    for label, wrapper, a, kw in shading_calls():
        fn = lambda: wrapper(*a, **kw)  # noqa: E731
        print(f"{wrapper.__name__} {label}: {a[5].shape[0]} rays, {live(a)} live; device "
              f"{device_ms(fn, 10, per_call=None)} ms, wrapper by CUDA events "
              f"{cuda_ms(fn, 20)} ms", flush=True)


def same(name, x, y):
    if name.startswith("occlude"):  # the sums are specified where `opq` is false
        return same_occlusion(x, y)
    return all(torch.equal(u, v) for u, v in zip(x, y))


# the resident scenes of `occlusion`: the 1080p stand-in (2 blocks of 64), the
# two partitions of harness.PARTITIONS (semesterbild plus 2400 small
# triangles, a quarter glass: a superblock of 64 blocks; blocks of 48 rows)
# and a cloud of ~230 blocks below `stream_triangles` (semesterbild plus
# 15,000 small triangles, triangle_cloud.build_scene's other defaults)
OCCLUSION_SCENES = {
    "stand-in": (dict(), lambda c: build("semesterbild", c)),
    **{name: (part, lambda c: triangle_cloud.build_scene(c, n=2400, edge_sigma=0.006,
                                                         glass_share=0.25))
       for name, part in PARTITIONS.items()},
    "cloud": (dict(), lambda c: triangle_cloud.build_scene(c, n=15000)),
}


def occlusion_cases():
    """(label, scene, kw, (o, d, max distance), real) of every scene of
    OCCLUSION_SCENES at 10,240, 655,360 and 2,097,152 shadow rays."""
    out = []
    for name, (part, make) in OCCLUSION_SCENES.items():
        c = RenderConfig(width=1920, height=1080, **MAIN, **REALISTIC, **part)
        c_soft = RenderConfig(width=1920, height=1080, **MAIN, **REALISTIC, **part,
                              soft_shadows=True)
        host = make(c)
        scene = RaytracerRenderer(c, device="cuda").device_scene(host)
        assert not scene.streaming
        soft = RaytracerRenderer(c_soft, device="cuda").device_scene(host)
        # tile 3's primary rays and its first pool iteration's W rays, as
        # the cast of the render saw them
        (prim, _), (pool, _) = caught_calls(["cast_triangles"], tile_call(scene, c, 3),
                                            2)["cast_triangles"]
        kw = dict(backface_culling=c.backface_culling, bigtri_trans=scene.bigtri_trans,
                  block_has_trans=scene.block_has_trans, sb_sizes=scene.sb_sizes)
        for sc, cc, (o, d) in ((scene, c, pool[4:6]), (scene, c, prim[4:6]),
                               (soft, c_soft, prim[4:6])):
            so, sd, md, real = shadow_rays(sc, cc, o, d, torch.ones(o.shape[0], dtype=torch.bool,
                                                                    device="cuda"))[0]
            label = (f"{name} ({scene.triangle_blocks} blocks of {scene.tri_block}, superblocks "
                     f"of up to {max(scene.sb_sizes)}), {so.shape[0]} rays")
            out.append((label, scene, kw, (so, sd, md), real))
    return out


def occl_hash(out):
    """A hash of an occlusion result: `opq`, and the sums' bits where it is
    false (the sums of an occluded ray are not specified)."""
    dec, opq, fsub = out
    free = ~opq
    h = hashlib.sha256(opq.cpu().numpy().tobytes())
    for x in (dec[free], fsub[free]):
        h.update(x.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def occlusion_times():
    for label, scene, kw, rays, real in occlusion_cases():
        tables = (scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb)
        fn = lambda: kernels.occlude_triangles(*tables, *rays, **kw)  # noqa: E731
        out = fn()
        n = 20 if rays[0].shape[0] > 100_000 else 100
        dev, ev = device_ms(fn, n), cuda_ms(fn, n)
        tests, n_live, n_opq, crossed = occlusion_tests(
            scene, *rays, out[1], real, int((scene.trb_pack[:, 13] != 0).sum()))
        b, by = bound_ms(nbytes(*rays, *tables, *out), OPS_OCCL * tests)
        share = "not measured" if dev is None else f"{b / dev:.1%} of it on the device alone"
        # the one-thread scan's pair tests, and the share of a warp's lanes
        # busy when each of 32 consecutive rays takes a lane
        lens = scan_lengths(scene, *rays, kw["backface_culling"])
        per_warp = torch.nn.functional.pad(lens, (0, -lens.shape[0] % 32)).view(-1, 32)
        busy = float(per_warp.sum() / (32 * per_warp.amax(1)).sum().clamp(min=1))
        rate = "" if dev is None else f", {float(lens.sum()) / dev / 1e9:.3f} per ns"
        print(f"occlude_triangles {label}: device {dev} ms, by CUDA events {ev} ms; bound "
              f"{b:.5f} ms ({by}), {share}; real rays {int(real.sum())}, occluded {n_opq}, "
              f"live {n_live}, {crossed / max(n_live, 1):.2f} blocks crossed per live ray; "
              f"the one-thread scan's pair tests {int(lens.sum())}{rate}, lanes busy {busy:.1%} "
              f"with a ray per lane; results {occl_hash(out)}", flush=True)


def occlusion_forms():
    """occlude_triangles in its two forms on the cases of `kernels`, in
    turns."""
    least = kernels.PACKET_MIN_RAYS
    forms_ = {"one ray per warp": 1 << 30, "a ray per lane": 0}
    for label, scene, kw, rays, _ in occlusion_cases():
        tables = (scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb)
        fn = lambda: kernels.occlude_triangles(*tables, *rays, **kw)  # noqa: E731
        ms, hashes = {f: [] for f in forms_}, set()
        n = 20 if rays[0].shape[0] > 100_000 else 100
        for form in (*forms_, *reversed(forms_)):
            kernels.PACKET_MIN_RAYS = forms_[form]
            hashes.add(occl_hash(fn()))
            ms[form].append((cuda_ms(fn, n), device_ms(fn, n)))
        kernels.PACKET_MIN_RAYS = least
        assert len(hashes) == 1, (label, hashes)
        print(f"occlude_triangles {label}, ms by CUDA events and on the device alone: " +
              ", ".join(f"{f} {m}" for f, m in ms.items()) + "; the same results", flush=True)


def forms():
    least = kernels.PACKET_MIN_RAYS
    for scene_name, kernel_names in KERNELS.items():
        if scene_name not in ARGS.scene:
            continue
        scene = scene_of(scene_name)
        for name, calls in caught_calls(kernel_names, tile_call(scene, cfg, 3), 2).items():
            wrapper = getattr(kernels, name)
            # the streamed kernels at the pool's width only, the resident ones at R and W
            for a, kw in calls if scene_name == "semesterbild" else calls[1:]:
                ms, outs = {"one": [], "many": []}, {}
                for form in ("one", "many", "many", "one"):
                    kernels.PACKET_MIN_RAYS = 1 << 30 if form == "one" else 0
                    outs[form] = wrapper(*a, **kw)
                    fn = lambda: wrapper(*a, **kw)  # noqa: E731
                    ms[form].append((cuda_ms(fn, 50), device_ms(fn, 20)))
                kernels.PACKET_MIN_RAYS = least
                assert same(name, outs["one"], outs["many"]), name
                many = "a ray per lane" if scene_name == "semesterbild" else "eight rays per warp"
                print(f"{name} at {n_rays(name, a)} rays (tile 3), ms by CUDA events and on the "
                      f"device alone: one ray per warp {ms['one']}, {many} {ms['many']}; the "
                      f"same results", flush=True)
    if "occlusion" in ARGS.scene:
        occlusion_forms()
    if "semesterbild" not in ARGS.scene:
        return
    # shade_eval's two forms, in turns, by its live rays
    forms_ = {"a warp per ray": 1 << 30, "a ray per lane": -1}
    for label, wrapper, a, kw in shading_calls(stride=3):
        if wrapper.__name__ != "shade_eval":
            continue
        first = kernels.NODE_WARP_MAX_LIVE
        ms, outs = {f: [] for f in forms_}, {}
        for form in (*forms_, *reversed(forms_)):
            kernels.NODE_WARP_MAX_LIVE = forms_[form]
            outs[form] = wrapper(*a, **kw)
            fn = lambda: wrapper(*a, **kw)  # noqa: E731
            ms[form].append((cuda_ms(fn, 20), device_ms(fn, 10, per_call=None)))
        kernels.NODE_WARP_MAX_LIVE = first
        x, y = outs.values()
        assert all(torch.equal(u.view(torch.int32) if u.dtype == torch.float32 else u,
                               v.view(torch.int32) if v.dtype == torch.float32 else v)
                   for u, v in zip(flat(x), flat(y))), label
        print(f"{wrapper.__name__} {label}, {live(a)} live rays, ms by CUDA events and on the "
              f"device alone: " + ", ".join(f"{f} {m}" for f, m in ms.items()) +
              "; the same bits", flush=True)


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
SASS_CLASSES = (("shared loads", ("LDS",)), ("global loads", ("LDG", "LD.")),
                ("f32 arithmetic", ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK")),
                ("MUFU", ("MUFU",)), ("branches", ("BRA",)))


def sass():
    kernels.build_kernels([ARGS.kernel])
    listing = subprocess.run(
        [os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump"), "-sass",
         kernels._so_path(ARGS.kernel)], capture_output=True, text=True, check=True).stdout
    out = ARGS.out or os.path.join(kernels.BUILD_DIR, f"sass_{ARGS.kernel}.txt")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        fh.write(listing)
    for part in listing.split("Function : ")[1:]:
        name = part.split()[0]
        code = [(int(m.group(1), 16), m.group(3), m.group(4)) for m in SASS_LINE.finditer(part)]
        print(f"{name}: {len(code)} instructions", flush=True)
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if not target or int(target.group(1), 16) >= addr:
                continue  # not a backward branch
            span = [o for a, o, _ in code if int(target.group(1), 16) <= a <= addr]
            counts = ", ".join(f"{label} {sum(o.startswith(p) for o in span for p in pre)}"
                               for label, pre in SASS_CLASSES)
            print(f"  loop {int(target.group(1), 16):#06x}-{addr:#06x}: {len(span)} "
                  f"instructions; {counts}", flush=True)
    print(f"listing: {out}", flush=True)


def cli():
    root = os.path.abspath(ARGS.root)
    out = ARGS.out or os.path.join(root, "out", f"cli_semesterbild_{ARGS.preset}.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "hslu_i.ba_raytracing.f2501_raytracer_tpu_torch", "--scene",
         "semesterbild", "--preset", ARGS.preset, "--out", out],
        cwd=root, capture_output=True, text=True, check=True)
    wall = time.monotonic() - t0
    timing = re.search(r"elapsed=([0-9.]+)s", run.stdout)
    with open(out, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    print(f"CLI semesterbild/{ARGS.preset}: process {wall:.1f} s, render "
          f"{timing.group(1) if timing else 'not printed'} s, PNG sha256 {digest}; "
          f"{run.stdout.strip().splitlines()[1]}", flush=True)


if ARGS.what == "frames":
    assert "occlusion" not in ARGS.scene, "occlusion is no frame's scene"
    frames(ARGS.n)
elif ARGS.what == "kernels":
    kernel_times()
elif ARGS.what == "shading":
    shading()
elif ARGS.what == "sass":
    sass()
elif ARGS.what == "cli":
    cli()
else:
    forms()
