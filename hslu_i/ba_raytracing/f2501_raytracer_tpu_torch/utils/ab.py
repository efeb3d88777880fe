"""Side measurements of the port on one NVIDIA GPU, kept out of
chip_smoke.py. Each run measures the package of one checkout, so that two
trees can take turns within one run (parent, change, change, parent): walls
and kernel times differ more between machines than between trees. Run as a
file from anywhere:

    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        frames N [--scene semesterbild semesterbild_cloud] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        kernels [--scene semesterbild semesterbild_cloud] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        shading [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py forms

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
           that ptxas gave the kernels' build.
shading    the two shading kernels off the main path at every shape they
           run, caught from renders: shade_eval at every wavefront of tile
           1 of the 960x540 stack-path frame (its live rays, valid != 0,
           beside each) and at the first pool iteration of the 240x135
           `packed_stage=False` frame (W = 512); light_shade at tile 3 of
           the 1080p `default` (5 lights) and `soft_shadows` (50 lights)
           frames. Each: the time on the device alone (all of a call's
           kernels) and of the wrapper by CUDA events; first, the registers.
forms      the four kernels with a warp per ray, with one ray per warp and
           with many (eight for the two streamed kernels, a ray per lane for
           the resident two), in turns one, many, many, one: the streamed
           kernels at the pool's width (2048 rays and 10,240 shadow rays),
           the resident ones at W and at R; what `kernels.PACKET_MIN_RAYS`
           decides between. Then shade_eval's two forms at every wavefront
           of the stack tile and at W = 512, against its live rays (what
           `kernels.NODE_WARP_MAX_LIVE` decides between). The results must
           be the same.
--root DIR imports the package from another checkout (one unpacked with
           `git archive`).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("what", choices=("frames", "kernels", "shading", "forms"))
parser.add_argument("n", type=int, nargs="?", default=2, help="frames: warm frames per scene")
parser.add_argument("--scene", nargs="+", choices=("semesterbild", "semesterbild_cloud"),
                    default=["semesterbild", "semesterbild_cloud"])
parser.add_argument("--root", default=os.path.join(os.path.dirname(__file__), *[".."] * 4),
                    help="the checkout whose package is imported (default: this one)")
ARGS = parser.parse_args()
# the package of checkout ARGS.root; the shared helpers (harness.py) of this
# one, which a parent checkout may lack
sys.path[0:1] = [os.path.abspath(ARGS.root), os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402
from harness import caught_calls, cuda_ms, device_ms, flat, tile_call  # noqa: E402

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (  # noqa: E402
    RaytracerRenderer,
    RenderConfig,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build  # noqa: E402
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
cfg = RenderConfig(width=1920, height=1080, **MAIN, **REALISTIC)
renderer = RaytracerRenderer(cfg, device="cuda")
print(f"{torch.cuda.get_device_name(0)}; package from {sys.path[0]}", flush=True)


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
    host wall, device busy time, launches per node evaluation, the kernels
    that take the most device time."""
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
    busy = sum(e.self_device_time_total for e in avg) / 1e3
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
    for scene_name in ARGS.scene:
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
        free = ~x[1]
        return (torch.equal(x[1], y[1]) and torch.equal(x[0][free], y[0][free])
                and torch.equal(x[2][free], y[2][free]))
    return all(torch.equal(u, v) for u, v in zip(x, y))


def forms():
    least = kernels.PACKET_MIN_RAYS
    for scene_name, kernel_names in KERNELS.items():
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


if ARGS.what == "frames":
    frames(ARGS.n)
elif ARGS.what == "kernels":
    kernel_times()
elif ARGS.what == "shading":
    shading()
else:
    forms()
