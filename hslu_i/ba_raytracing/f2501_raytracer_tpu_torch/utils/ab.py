"""Side measurements of the port on one NVIDIA GPU, kept out of
chip_smoke.py. Each run measures the package of one checkout, so that two
trees can take turns within one run (parent, change, change, parent): walls
and kernel times differ more between machines than between trees. Run as a
file from anywhere:

    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        frames N [--scene semesterbild semesterbild_cloud] [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/ab.py \
        kernels [--scene semesterbild semesterbild_cloud] [--root DIR]
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
           calls at R and 100 at W) and of the wrapper by CUDA events; before
           them, tile 3 traced with torch.profiler (device busy time,
           launches per node evaluation); first, the registers per thread
           that ptxas gave the kernels' build.
forms      the four kernels with a warp per ray, with one ray per warp and
           with many (eight for the two streamed kernels, a ray per lane for
           the resident two), in turns one, many, many, one: the streamed
           kernels at the pool's width (2048 rays and 10,240 shadow rays),
           the resident ones at W and at R; what `kernels.PACKET_MIN_RAYS`
           decides between. The results must be the same.
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
parser.add_argument("what", choices=("frames", "kernels", "forms"))
parser.add_argument("n", type=int, nargs="?", default=2, help="frames: warm frames per scene")
parser.add_argument("--scene", nargs="+", choices=("semesterbild", "semesterbild_cloud"),
                    default=["semesterbild", "semesterbild_cloud"])
parser.add_argument("--root", default=os.path.join(os.path.dirname(__file__), *[".."] * 4),
                    help="the checkout whose package is imported (default: this one)")
ARGS = parser.parse_args()
sys.path[0] = os.path.abspath(ARGS.root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (  # noqa: E402
    RaytracerRenderer,
    RenderConfig,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace  # noqa: E402
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import plan_frame  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("ab.py: no CUDA device available")
cfg = RenderConfig(
    width=1920, height=1080, scene_backface_culling=True, tile_rays=131072, max_nodes=48,
    weight_cutoff=1e-3, compaction_ratio=64, kernel_ray_tile=512, loop_chunk=96,
    device_encode=True, stage_mode="scatter", commit_splits=1,
    reflections=True, light_reflections=True, refractions=True,
)
renderer = RaytracerRenderer(cfg, device="cuda")
print(f"{torch.cuda.get_device_name(0)}; package from {sys.path[0]}", flush=True)


# the kernels of each scene's path, its node kernel first
KERNELS = {"semesterbild": ("cast_triangles", "shade_eval_rows"),
           "semesterbild_cloud": ("cast_triangles_stream", "occlude_triangles_stream")}


def scene_of(name):
    scene = renderer.device_scene(build(name, cfg))
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


def cuda_ms(fn, iters=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters):
    """Device time of one call's kernels written in this repository
    (torch.profiler; chip_smoke.py's `device_ms`), None if a trace missed
    them."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages() if "anonymous namespace" in e.key]
        n = sum(e.count for e in ours)
        if n:
            return round(sum(e.self_device_time_total for e in ours) / 1e3 / n, 5)
    return None


def caught_calls(scene, names):
    """The first two calls of each wrapper in `names` while tile 3 of the
    frame renders: the tile's primary node, then its first pool iteration.
    Tensor arguments are copied: the pool reuses its buffers."""
    wrappers = {name: getattr(kernels, name) for name in names}
    caught = {name: [] for name in names}

    def catching(name):
        def catch(*a, **kw):
            if len(caught[name]) < 2:
                caught[name].append(([x.clone() if isinstance(x, torch.Tensor) else x
                                      for x in a], kw))
            return wrappers[name](*a, **kw)
        return catch

    for name in names:
        setattr(kernels, name, catching(name))
    tile3(scene)()
    torch.cuda.synchronize()
    for name, wrapper in wrappers.items():
        setattr(kernels, name, wrapper)
    return {name: (wrappers[name], calls) for name, calls in caught.items()}


def tile3(scene):
    """A call that renders tile 3 of the 1080p frame of `scene`."""
    plan = plan_frame(cfg)
    R = plan.pix_per_tile * plan.aa
    order = torch.from_numpy(np.ascontiguousarray(plan.order[3 * R: 4 * R])).to("cuda")
    per_tile = trace.make_raygen_per_tile(
        scene, cfg, torch.zeros((1, 3), device="cuda"), torch.ones(1, device="cuda"), R)
    return lambda: per_tile(order)


def traced_tile(name, scene):
    """Tile 3 traced with torch.profiler, as chip_smoke.py's `profile_tile`:
    host wall, device busy time, launches per node evaluation, the kernels
    that take the most device time."""
    run = tile3(scene)
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
        for name, (wrapper, calls) in caught_calls(scene, KERNELS[scene_name]).items():
            for label, (a, kw), n in zip(("R", "W"), calls, (20, 100)):
                fn = lambda: wrapper(*a, **kw)  # noqa: E731
                print(f"{name} {label} ({n_rays(name, a)} rays): device {device_ms(fn, n)} ms, "
                      f"wrapper by CUDA events {round(cuda_ms(fn, n), 5)} ms", flush=True)


def same(name, x, y):
    if name.startswith("occlude"):  # the sums are specified where `opq` is false
        free = ~x[1]
        return (torch.equal(x[1], y[1]) and torch.equal(x[0][free], y[0][free])
                and torch.equal(x[2][free], y[2][free]))
    return all(torch.equal(u, v) for u, v in zip(x, y))


def forms():
    least = kernels.PACKET_MIN_RAYS
    for scene_name, kernel_names in KERNELS.items():
        for name, (wrapper, calls) in caught_calls(scene_of(scene_name), kernel_names).items():
            # the streamed kernels at the pool's width only, the resident ones at R and W
            for a, kw in calls if scene_name == "semesterbild" else calls[1:]:
                ms, outs = {"one": [], "many": []}, {}
                for form in ("one", "many", "many", "one"):
                    kernels.PACKET_MIN_RAYS = 1 << 30 if form == "one" else 0
                    outs[form] = wrapper(*a, **kw)
                    fn = lambda: wrapper(*a, **kw)  # noqa: E731
                    ms[form].append((round(cuda_ms(fn), 4), device_ms(fn, 20)))
                kernels.PACKET_MIN_RAYS = least
                assert same(name, outs["one"], outs["many"]), name
                many = "a ray per lane" if scene_name == "semesterbild" else "eight rays per warp"
                print(f"{name} at {n_rays(name, a)} rays (tile 3), ms by CUDA events and on the "
                      f"device alone: one ray per warp {ms['one']}, {many} {ms['many']}; the "
                      f"same results", flush=True)


if ARGS.what == "frames":
    frames(ARGS.n)
elif ARGS.what == "kernels":
    kernel_times()
else:
    forms()
