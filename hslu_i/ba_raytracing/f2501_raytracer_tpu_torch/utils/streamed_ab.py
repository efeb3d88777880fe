"""Side measurements of the streamed path on one NVIDIA GPU, kept out of
chip_smoke.py. Run as a file from anywhere:

    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/streamed_ab.py \
        frames N [--root DIR]
    python3 hslu_i/ba_raytracing/f2501_raytracer_tpu_torch/utils/streamed_ab.py forms

frames N   render the 1920x1080 `realistic` frame of `semesterbild_cloud`
           (the streamed path, chip_smoke.py's settings) once to warm up and N
           times more; print each wall time, the launches and the u32
           checksum. `--root DIR` imports the package from another checkout
           (one unpacked with `git archive`), so two trees can take turns
           within one run: walls differ more between machines than between
           trees.
forms      the two streamed kernels at the pool's width (the 2048 rays and
           10,240 shadow rays of a 1080p tile's first pool iteration, caught
           from a render), with one ray per warp and with eight, in turns
           1, 8, 8, 1: what `kernels.PACKET_MIN_RAYS` decides between.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("what", choices=("frames", "forms"))
parser.add_argument("n", type=int, nargs="?", default=2)
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

cfg = RenderConfig(
    width=1920, height=1080, scene_backface_culling=True, tile_rays=131072, max_nodes=48,
    weight_cutoff=1e-3, compaction_ratio=64, kernel_ray_tile=512, loop_chunk=96,
    device_encode=True, stage_mode="scatter", commit_splits=1,
    reflections=True, light_reflections=True, refractions=True,
)
renderer = RaytracerRenderer(cfg, device="cuda")
scene = renderer.device_scene(build("semesterbild_cloud", cfg))
assert scene.streaming
print(f"{torch.cuda.get_device_name(0)}; package from {sys.path[0]}", flush=True)


def frames(n):
    for k in range(n + 1):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        fb = renderer.render_u32(scene)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        assert renderer.last_dropped == 0
        print(f"streamed 1920x1080 frame {k}{' (warm-up)' if k == 0 else ''}: "
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


def forms():
    # catch the second call of each wrapper in a tile's render: the first
    # pool iteration (the first call is the tile's primary node)
    wrappers = {name: getattr(kernels, name)
                for name in ("cast_triangles_stream", "occlude_triangles_stream")}
    caught = {name: [] for name in wrappers}

    def catching(name):
        def catch(*a, **kw):
            caught[name].append((a, kw))
            return wrappers[name](*a, **kw)
        return catch

    for name in wrappers:
        setattr(kernels, name, catching(name))
    plan = plan_frame(cfg)
    R = plan.pix_per_tile * plan.aa
    order = torch.from_numpy(np.ascontiguousarray(plan.order[3 * R: 4 * R])).to("cuda")
    per_tile = trace.make_raygen_per_tile(
        scene, cfg, torch.zeros((1, 3), device="cuda"), torch.ones(1, device="cuda"), R)
    per_tile(order)
    torch.cuda.synchronize()
    for name, calls in caught.items():
        wrapper = wrappers[name]
        setattr(kernels, name, wrapper)
        a, kw = calls[1]
        n_rays = a[3].shape[0]
        assert kernels.rays_per_warp(n_rays) == 1
        ms, outs = {1: [], 8: []}, {}
        least = kernels.PACKET_MIN_RAYS
        for k in (1, 8, 8, 1):
            kernels.PACKET_MIN_RAYS = least if k == 1 else 1
            assert kernels.rays_per_warp(n_rays) == k
            outs[k] = wrapper(*a, **kw)
            ms[k].append(round(cuda_ms(lambda: wrapper(*a, **kw)), 4))
        kernels.PACKET_MIN_RAYS = least
        # the same hits; occlusion sums are specified where `opq` is false
        if name == "cast_triangles_stream":
            assert all(torch.equal(x, y) for x, y in zip(outs[1], outs[8]))
        else:
            free = ~outs[1][1]
            assert torch.equal(outs[1][1], outs[8][1])
            assert torch.equal(outs[1][0][free], outs[8][0][free])
            assert torch.equal(outs[1][2][free], outs[8][2][free])
        print(f"{name} at {n_rays} rays (first pool iteration of tile 3): one ray per warp "
              f"{ms[1]} ms, eight {ms[8]} ms; the same results", flush=True)


frames(ARGS.n) if ARGS.what == "frames" else forms()
