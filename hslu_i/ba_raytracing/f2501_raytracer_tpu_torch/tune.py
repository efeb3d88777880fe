"""Per-scene `triangle_block` auto-tuner.

The port's counterpart of the JAX package's `tune.py`. The best Morton
block size depends on the scene, the frame size and the kernels, so
`autotune` measures instead of guessing: it times one representative ray
tile per candidate in the current process and returns the fastest
candidate's config and device scene, ready to render. Every candidate
renders the same image up to the order of the shadow sums over blocks (the
block size only regroups the scans), so this is a choice of speed alone.

The reference has no analog: its tile size is a compile-time lcm/gcd
constant (renderer/mod.rs:84-90).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import RenderConfig
from .ops.trace import trace_rays
from .renderer import build_frame_rays, plan_frame
from .scene.builder import Scene
from .scene.device import DeviceScene, build_device_scene
from .utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class TuneResult:
    cfg: RenderConfig
    device_scene: DeviceScene
    timings_ms: dict  # candidate triangle_block -> best-of-repeats ms
    tuned_block: int


def _probe_rays(cfg: RenderConfig, n: int) -> tuple[np.ndarray, np.ndarray]:
    """A representative wavefront: the frame's central rays in the
    renderer's tile-major layout (central tiles see the scene; border tiles
    can be all background and would reward culling too much)."""
    o, d = build_frame_rays(cfg, plan_frame(cfg))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    start = max(0, min(len(o) // 2 - n // 2, len(o) - n))
    return o[start:start + n], d[start:start + n]


def autotune(
    scene: Scene,
    cfg: RenderConfig,
    candidates: Sequence[int] = (32, 64, 128, 256, 512),
    repeats: int = 3,
    tile: Optional[int] = None,
    verbose: bool = False,
    device=None,
) -> TuneResult:
    """Time one `tile`-ray wavefront (default: cfg.tile_rays) per
    triangle_block candidate on `device` (default: the card) and return the
    fastest candidate's (cfg, device_scene). Each candidate's time is the
    best of `repeats` calls after one warm call, on the host clock around a
    synchronise."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    o_np, d_np = _probe_rays(cfg, tile or cfg.tile_rays)
    o = torch.from_numpy(np.ascontiguousarray(o_np)).to(dev)
    d = torch.from_numpy(np.ascontiguousarray(d_np)).to(dev)
    timings: dict[int, float] = {}
    best = None
    for block in candidates:
        cand = dataclasses.replace(cfg, triangle_block=int(block))
        ds = build_device_scene(scene, cand, device=dev)
        trace_rays(ds, cand, o, d)  # warm
        sync()
        ms = float("inf")
        for _ in range(repeats):
            t0 = time.monotonic()
            trace_rays(ds, cand, o, d)
            sync()
            ms = min(ms, (time.monotonic() - t0) * 1e3)
        timings[int(block)] = ms
        if verbose:
            print(f"autotune: triangle_block={block}: {ms:.2f} ms", flush=True)
        if best is None or ms < timings[best[0].triangle_block]:
            best = (cand, ds)
    return TuneResult(cfg=best[0], device_scene=best[1], timings_ms=timings,
                      tuned_block=best[0].triangle_block)
