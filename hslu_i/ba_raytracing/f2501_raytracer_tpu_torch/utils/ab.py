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
        shading [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        forms [--scene semesterbild semesterbild_cloud occlusion]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        nodes [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        sass [--kernel NAME] [--out PATH]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        cli [--preset NAME] [--out PATH] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        pool N

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
nodes      shade_eval_rows at the pool's two widths, W = 2048 (the first
           pool iteration of tile 3 of the 1080p `realistic` frame) and
           W = 3584 (the same of the 480x270 `extreme` frame, AA samples
           and all), each under the light packs of 5, 50, 95 and 140 lights
           (the light clouds of harness.LIGHT_FEATURES; 140: extreme's own)
           and under the first 10, 20 and 30 lights of the 50, and at
           W = 1536 (the same of 1140x950 `reference_default`, 95 lights),
           in each of its forms in turns: a warp per ray, a ray per lane
           and, where the tree has it, the light-lanes form (a warp per
           ray, its lights over the lanes; kernels.node_form). Each: the
           time on the device alone per form, which form the tree takes,
           the call's lit (ray, light) pairs and shadow rows scanned up to
           the first opaque hit (frame_bench/framebench/roofline.py's
           count), its bound, and the share of the light-lanes form's lane
           slots that scan rows, with its rounds and without (a lane going
           on to its next light at once). The results must be the same.
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
pool N     the pool iteration in its two forms, in turns glue, fused, fused,
           glue: in PyTorch ops around the two kernels (ops/trace.py's
           `glue_step`, forced where the fused form applies) and as five
           kernels (`fused_step`), on the 1920x1080 `realistic` frame (W =
           2048) and the 480x270 `extreme` frame (W = 3584). Each turn: the
           graphs dropped, two frames to capture, N timed frames (walls and
           u32 checksums), one frame traced with torch.profiler (device
           busy time, device operations per pool iteration, the top device
           operations), then the device time of one replayed chunk by CUDA
           events (the mean over 20 replays) on the last tile's buffers with
           4W rays pending (`live`) and with none (`drained`), the pool
           restored before each replay. This checkout only.
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
parser.add_argument("what",
                    choices=("frames", "kernels", "shading", "forms", "nodes", "sass", "cli",
                             "pool"))
parser.add_argument("n", type=int, nargs="?", default=2, help="frames: warm frames per scene")
parser.add_argument("--scene", nargs="+",
                    choices=("semesterbild", "semesterbild_cloud", "occlusion"),
                    default=["semesterbild", "semesterbild_cloud"])
parser.add_argument("--kernel", default="occlude_triangles", help="sass: the kernel")
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
    LIGHT_FEATURES,
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
)
from timing import device_busy_ms  # noqa: E402 (this checkout's, as harness.py)

# the roofline's count of a shading call (this checkout's benchmark)
sys.path.insert(2, os.path.join(os.path.dirname(os.path.abspath(__file__)), *[".."] * 4,
                                "frame_bench"))
from framebench import roofline  # noqa: E402

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (  # noqa: E402
    RaytracerRenderer,
    RenderConfig,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import (  # noqa: E402
    build,
    triangle_cloud,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels  # noqa: E402

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


def shading():
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


# shade_eval_rows' forms by the settings that choose them: (PACKET_MIN_RAYS,
# LIGHT_LANES_MIN_LIGHTS)
NODE_FORMS = {"a warp per ray": (1 << 30, 1 << 30), "a ray per lane": (0, 1 << 30),
              "light lanes": (1 << 30, 0)}


def node_calls():
    """(label, args, kw) of `nodes`: the first pool call of tile 3 of the
    1080p `realistic` and the 480x270 `extreme` frames, caught from renders,
    each with the light pack of every light count of LIGHT_FEATURES and with
    the first 10, 20 and 30 lights of the 50; and the same call of the
    1140x950 `reference_default` frame at its own 95 lights."""
    c_ext = RenderConfig(width=480, height=270, **dict(MAIN, tile_rays=262144), **EXTREME)
    c_ref = RenderConfig.reference_default(
        **{k: v for k, v in MAIN.items() if k != "scene_backface_culling"})
    packs = {n: scene_of("semesterbild", RenderConfig(width=1920, height=1080, **MAIN,
                                                      **REALISTIC, **feats)).light_pack
             for n, feats in LIGHT_FEATURES.items()}
    lights = list(packs.items())
    lights[1:1] = [(n, packs[50]) for n in (10, 20, 30)]
    out = []
    for where, c, n_own in (("realistic 1920x1080", cfg, 5), ("extreme 480x270", c_ext, 140),
                            ("reference_default 1140x950", c_ref, 95)):
        _, (a, kw) = caught_calls(["shade_eval_rows"], tile_call(
            scene_of("semesterbild", c), c, 3, aa=n_own > 5), 2)["shade_eval_rows"]
        assert kw["n_lights"] == n_own, kw["n_lights"]
        for n, pack in lights if n_own < 95 else [(n_own, a[0])]:
            out.append((f"{where} tile 3's first pool call (W = {a[5].shape[0]}), {n} lights",
                        [pack, *a[1:]], dict(kw, n_lights=n)))
    return out


def pair_rows(a, kw):
    """The shadow rows each lit (ray, light) pair of a shading call scans up
    to its first opaque hit, spheres counted as rows: (n_lights, live rays)
    int64, 0 where the light is not lit. The roofline's walk
    (roofline.shade_ops), pair by pair."""
    light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb = a[:5]
    keep = a[10] != 0
    P, N = a[5][keep], a[6][keep]
    n_sph = int((sph_pack[:, 12] != 0).sum())
    packs = [(trb_pack, None)] + [(tri_blk_pack[b], tri_blk_aabb[b])
                                  for b in range(tri_blk_pack.shape[0])]
    out = torch.zeros((kw["n_lights"], P.shape[0]), dtype=torch.int64, device=P.device)
    for li in range(kw["n_lights"]):
        lp = light_pack[li, 0:3]
        ltp = lp[None, :] - P
        lt = ltp.norm(dim=1)
        lit = (ltp * N).sum(1) / lt > 0
        ld = ltp[lit] / lt[lit, None]
        so = P[lit] + ld * kw["eps_dist"]
        maxd = (lp[None, :] - so).norm(dim=1)
        rows = torch.full_like(maxd, n_sph, dtype=torch.int64)
        st, sv = roofline._sphere_ts(sph_pack[:, 0:3], sph_pack[:, 3], sph_pack[:, 12] != 0, so,
                                     ld)
        live_ = ~(sv & (st <= maxd[:, None]) & (sph_pack[None, :, 8] == 0)).any(1)
        for pack, box in packs:
            scan = live_ if box is None else live_ & roofline.gate_hits(box[None], so, ld,
                                                                       maxd)[:, 0]
            t, v = roofline._woop_ts(pack, so, ld)
            stop = v & (t <= maxd[:, None]) & (pack[None, :, 14] == 0)
            n_rows = int((pack[:, 13] != 0).sum()) if box is None else pack.shape[0]
            upto = torch.where(stop.any(1), stop.float().argmax(1).long() + 1,
                               torch.full_like(rows, n_rows))
            rows += torch.where(scan, upto, 0)
            live_ = live_ & ~(scan & stop.any(1))
        out[li, lit] = rows
    return out


def lane_use(rows):
    """The share of the lanes' issue slots that scan rows, for the warps of
    a light-lanes call (a warp a ray, ceil(L / 32) rounds of an even share
    of lanes, a round as long as its longest scan), and for the same lights
    on the same lanes if a lane went on to its next light without waiting
    for the round."""
    L, n = rows.shape
    rounds = -(-L // 32)
    width = -(-L // rounds)
    per = torch.nn.functional.pad(rows, (0, 0, 0, rounds * width - L)).view(rounds, width, n)
    work = float(rows.sum())
    return (work / max(32 * float(per.amax(1).sum()), 1.0),
            work / max(32 * float(per.sum(0).amax(0).sum()), 1.0))


def nodes():
    registers()
    lanes = hasattr(kernels, "LIGHT_LANES_MIN_LIGHTS")
    forms_ = {k: v for k, v in NODE_FORMS.items() if lanes or k != "light lanes"}
    keep = kernels.PACKET_MIN_RAYS, getattr(kernels, "LIGHT_LANES_MIN_LIGHTS", None)
    for label, a, kw in node_calls():
        fn = lambda: kernels.shade_eval_rows(*a, **kw)  # noqa: E731
        takes = kernels.node_form(a[5].shape[0], kw["n_lights"]) if lanes else 1
        ms, outs = {f: [] for f in forms_}, {}
        for form in (*forms_, *reversed(forms_)):
            kernels.PACKET_MIN_RAYS = forms_[form][0]
            if lanes:
                kernels.LIGHT_LANES_MIN_LIGHTS = forms_[form][1]
            outs[form] = flat(fn())
            ms[form].append(device_ms(fn, 20))
        kernels.PACKET_MIN_RAYS = keep[0]
        if lanes:
            kernels.LIGHT_LANES_MIN_LIGHTS = keep[1]
        first = outs["a warp per ray"]
        assert all(all(same_bits(x, y) for x, y in zip(first, o)) for o in outs.values()), label
        rows = pair_rows(a, kw)
        rounds, free = lane_use(rows)
        b, by = bound_ms(nbytes(*a, *first), roofline.shade_ops("shade_eval_rows", a,
                                                                kw["n_lights"], kw["eps_dist"]))
        print(f"shade_eval_rows {label}: {live(a)} live rays, {int((rows > 0).sum())} lit (ray, "
              f"light) pairs, {int(rows.sum())} rows scanned (spheres counted as rows); lanes "
              f"busy in the light-lanes form's rounds {rounds:.1%}, without rounds {free:.1%}; "
              f"bound {b:.5f} ms ({by}); device ms "
              + ", ".join(f"{k} {v}" for k, v in ms.items())
              + f"; this tree takes {'light lanes' if takes == 0 else takes}; the same bits",
              flush=True)


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


def pool():
    from torch.autograd import DeviceType

    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import trace
    from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import plan_frame

    fused = trace._fuses
    cases = {"realistic": cfg,
             "extreme": RenderConfig(width=480, height=270, **dict(MAIN, tile_rays=262144),
                                     **EXTREME)}
    sync = torch.cuda.synchronize
    for name, c in cases.items():
        r = RaytracerRenderer(c, device="cuda")
        scene = r.device_scene(build("semesterbild", c))
        n_tiles = plan_frame(c).n_tiles
        for form in ("glue", "fused", "fused", "glue"):
            trace._fuses = fused if form == "fused" else (lambda *a: False)
            trace.drop_pool_graphs()
            r.render_u32(scene)  # the first chunk of the key runs eagerly,
            r.render_u32(scene)  # the next is captured
            walls, sums = [], set()
            for _ in range(ARGS.n):
                sync()
                t0 = time.monotonic()
                fb = r.render_u32(scene)
                sync()
                walls.append((time.monotonic() - t0) * 1e3)
                sums.add(hashlib.sha256(fb.tobytes()).hexdigest()[:16])
            kernels.reset_launch_counts()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                r.render_u32(scene)
                sync()
            iters = kernels.LAUNCHES["shade_eval_rows"] - n_tiles
            ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            busy = device_busy_ms(prof.events())
            top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:6]
            g = next(iter(trace._graphs.values()))
            b = g.bufs
            snap = b.pool.clone()
            chunk_ms = {}
            for label, n0 in (("live", 4 * b.W), ("drained", 0)):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ms = []
                for _ in range(20):
                    b.pool.copy_(snap)
                    b.count.fill_(n0)
                    b.dropped.zero_()
                    e0.record()
                    g.captured.replay()
                    e1.record()
                    sync()
                    ms.append(e0.elapsed_time(e1))
                chunk_ms[label] = sum(ms) / len(ms)
            print(f"{name} {c.width}x{c.height} {form}: frames ms {[round(w, 1) for w in walls]}, "
                  f"u32 sha256 {sorted(sums)}; traced: {iters} pool iterations, device busy "
                  f"{busy:.1f} ms, {len(ops)} device operations ({len(ops) / iters:.1f} per "
                  f"iteration, prologues included); a chunk of {b.chunk} iterations by CUDA "
                  f"events: live {chunk_ms['live']:.4f} ms, drained {chunk_ms['drained']:.4f} ms",
                  flush=True)
            for e in top:
                print(f"  {e.self_device_time_total / 1e3:8.3f} ms device  x{e.count:<6d} "
                      f"{e.key[:70]}", flush=True)
    trace._fuses = fused


if ARGS.what == "frames":
    assert "occlusion" not in ARGS.scene, "occlusion is no frame's scene"
    frames(ARGS.n)
elif ARGS.what == "kernels":
    kernel_times()
elif ARGS.what == "shading":
    shading()
elif ARGS.what == "nodes":
    nodes()
elif ARGS.what == "sass":
    sass()
elif ARGS.what == "cli":
    cli()
elif ARGS.what == "pool":
    pool()
else:
    forms()
