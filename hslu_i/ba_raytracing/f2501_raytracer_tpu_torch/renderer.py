"""Top-level renderer: frame plan, tiles, device-side encode, host assembly.

The port's counterpart of the JAX package's `renderer.py` for the
single-device `device_encode` path (ref renderer/raytracer_renderer.rs:
1140-1379, renderer/mod.rs:80-210): the frame is cut into ray wavefronts of
`cfg.tile_rays`, primary rays are generated on the device from the
tile-major pixel permutation, every tile is traced (ops/trace.py:
the pool or the stack path, or the primary node alone without reflections
and refractions) and encodes its pixels to 0xFFRRGGBB on the device, and
the host fetches the 4-byte pixels once at the end.

Not in this slice (raise NotImplementedError; ROADMAP.md Queue 1): the
progress callback path, `device_encode=False`, multi-device meshes and
packet mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import RenderConfig
from .framebuffer import ImageBuffer
from .ops.camera import (
    antialiasing_offsets,
    antialiasing_weighted_offsets,
    tile_major_order,
)
from .ops.trace import trace_rays_tiled_u32_gen
from .scene.builder import Scene
from .scene.device import DeviceScene, build_device_scene
from .utils.devices import resolve_device
from .utils.timing import RenderTiming


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """One frame's ray layout: tile-major square pixel patches keep each
    kernel thread block's rays spatially close (ops/camera.py
    tile_major_order)."""

    order: np.ndarray  # tile-major position -> row-major pixel index
    offsets: np.ndarray  # (U, 3) AA origin offsets (deduped when configured)
    weights: np.ndarray  # (U,) per-sample weights, sum to 1
    pix_per_tile: int
    n_tiles: int

    @property
    def aa(self) -> int:  # samples actually traced per pixel
        return self.offsets.shape[0]


def plan_frame(cfg: RenderConfig) -> FramePlan:
    H, W = cfg.height, cfg.width
    total_pixels = H * W
    if cfg.anti_aliasing:
        if cfg.dedupe_aa and not cfg.packet_mode:
            offsets, weights = antialiasing_weighted_offsets(cfg, cfg.aa_packet_lanes)
        else:
            offsets = antialiasing_offsets(cfg, cfg.aa_packet_lanes)
            weights = np.full(
                (offsets.shape[0],), 1.0 / cfg.total_aa_rays, np.float32
            )
    else:
        offsets = np.zeros((1, 3), np.float32)
        weights = np.ones((1,), np.float32)
    U = offsets.shape[0]
    # don't let tile padding exceed the frame: shrink the tile when the
    # image is smaller than one tile
    eff_tile = min(
        cfg.tile_rays, max(1024, ((total_pixels * U + 1023) // 1024) * 1024)
    )
    pix_per_tile = max(eff_tile // U, 1)
    n_tiles = (total_pixels + pix_per_tile - 1) // pix_per_tile
    return FramePlan(
        order=tile_major_order(W, H),
        offsets=offsets,
        weights=weights,
        pix_per_tile=pix_per_tile,
        n_tiles=n_tiles,
    )


def frame_order_device(cfg: RenderConfig, plan: FramePlan, n_pad: int, device=None):
    """Device inputs for trace_rays_tiled_u32_gen: the tile-major pixel
    permutation padded with -1 to n_pad tiles and the AA offset table."""
    dev = resolve_device(device)
    slots = n_pad * plan.pix_per_tile
    order_pad = np.full((slots,), -1, np.int64)
    order_pad[: plan.order.shape[0]] = plan.order
    return (
        torch.from_numpy(order_pad).to(dev),
        torch.from_numpy(np.ascontiguousarray(plan.offsets, np.float32)).to(dev),
    )


def _warn_drops(n_dropped: int) -> None:
    """Loud pool saturation warning (the reference recursion never drops
    subtrees -- any nonzero count means reflection/refraction energy was
    lost, raytracer_renderer.rs:216-248)."""
    if n_dropped:
        print(
            f"WARNING: ray pool saturated — {n_dropped} pending "
            "secondary rays dropped (reflection/refraction energy lost)"
        )


class RaytracerRenderer:
    """Renders on `device` (default: the card; `device="cpu"` runs the plain
    PyTorch twins, as the tests do)."""

    def __init__(self, cfg: RenderConfig, device=None):
        self.device = resolve_device(device)
        if cfg.packet_mode:
            raise NotImplementedError("packet_mode is not ported yet (ROADMAP.md)")
        if cfg.devices != 1:
            raise NotImplementedError("multi-device rendering is not ported yet (ROADMAP.md)")
        if not cfg.device_encode:
            raise NotImplementedError(
                "the port renders through the device_encode path only (ROADMAP.md)"
            )
        self.cfg = cfg
        self.last_dropped = 0

    def device_scene(self, scene: Scene) -> DeviceScene:
        if self.cfg.scene_backface_culling:
            scene = Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0]))
        return build_device_scene(scene, self.cfg, device=self.device)

    def render(self, scene: Scene, progress: Optional[object] = None) -> ImageBuffer:
        if progress is not None:
            raise NotImplementedError("progressive rendering is not ported yet (ROADMAP.md)")
        return self.render_device(self.device_scene(scene))

    def render_u32(self, dscene: DeviceScene) -> np.ndarray:
        """The frame as (H*W,) uint32 0xFFRRGGBB pixels, row-major; 0 marks a
        pixel no sample hit. Sets `last_dropped`."""
        cfg = self.cfg
        plan = plan_frame(cfg)
        n_tiles = plan.n_tiles
        order_dev, offs_dev = frame_order_device(cfg, plan, n_tiles, self.device)
        w_dev = torch.from_numpy(np.ascontiguousarray(plan.weights, np.float32)).to(self.device)
        u32, dropped = trace_rays_tiled_u32_gen(
            dscene, cfg, order_dev, offs_dev, w_dev, n_tiles=n_tiles
        )
        total_pixels = cfg.width * cfg.height
        px = u32.reshape(-1).cpu().numpy().astype(np.uint32)  # one fetch
        self.last_dropped = int(dropped.sum())
        _warn_drops(self.last_dropped)
        fb = np.zeros((total_pixels,), np.uint32)
        fb[plan.order] = px[:total_pixels]
        return fb

    def render_device(self, dscene: DeviceScene) -> ImageBuffer:
        timing = RenderTiming()
        fb = self.render_u32(dscene)
        buf = ImageBuffer.from_u32(fb, self.cfg.width, self.cfg.height)
        timing.next()
        buf.timing = timing
        return buf
