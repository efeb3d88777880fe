"""Top-level renderer: frame plan, tiles, AA reduction, frame assembly.

The port's counterpart of the JAX package's `renderer.py` on one device
(ref renderer/raytracer_renderer.rs:1140-1379, renderer/mod.rs:80-210): the
frame is cut into ray wavefronts of `cfg.tile_rays` in the tile-major pixel
order, and every tile is traced (ops/trace.py: the pool or the stack path, or
the primary node alone without reflections and refractions). Three ways to a
frame, as in the JAX package:

* `device_encode` (and no `render_timing_debug`): primary rays generated on
  the device, the AA reduction and the 0xFFRRGGBB encode on the device; the
  tiles traced in launch groups (`tiles_per_program`, else the
  `fetch_groups` schedule), the 4-byte pixels of every group fetched once
  at the end (`render_u32`);
* the f32 path: rays built on the host (`build_frame_rays`), each group of
  `tiles_per_program` tiles traced and its colours fetched, the AA samples
  reduced on the host in numpy;
* with a progress callback: one tile at a time, each committed to the frame
  and handed to the callback as it finishes.

`get_pixel_color` traces one pixel's AA samples. `packet_mode` (the
reference's SIMD build) takes every path; its packets are the 8 AA lanes of
a pixel.

With `cfg.devices > 1` the u32 and f32 frame paths split each launch
group's tiles over a mesh of devices (parallel/mesh.py; JAX renderer.py
235-431): the scene replicated once per frame, the tiles traced on every
entry, the results joined on the lead device, the one-device frame's bits.
The progressive path, `get_pixel_color` and `render_timing_debug` run on
the lead device alone, as the JAX package runs them unsharded.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import RenderConfig
from .framebuffer import ImageBuffer
from .ops.camera import (
    antialiasing_offsets,
    antialiasing_weighted_offsets,
    pixel_scene_coords,
    tile_major_order,
)
from .ops.trace import (
    trace_rays,
    trace_rays_tiled,
    trace_rays_tiled_u32,
    trace_rays_tiled_u32_gen,
)
from .parallel.mesh import (
    mesh_of,
    shard_scene,
    trace_tiles_sharded,
    trace_tiles_sharded_u32,
    trace_tiles_sharded_u32_gen,
)
from .scene.builder import Scene
from .scene.device import DeviceScene, build_device_scene
from .utils import timing as spans
from .utils.devices import resolve_device
from .utils.timing import RenderTiming, TileStats


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


def fetch_schedule(n_tiles: int, max_groups: int = 8, align: int = 1) -> list:
    """Balanced front-loaded fetch-group sizes summing to `n_tiles` (JAX
    renderer.py:59-88, cfg.fetch_taper): q+1-sized groups first, then
    q-sized, q = n_tiles // groups, at most `max_groups` groups and two
    distinct sizes; the last group is the small one, whose fetch is the
    frame's exposed tail. `align` > 1 schedules in units of `align` tiles
    (n_tiles must divide)."""
    if align > 1:
        if n_tiles % align:
            raise ValueError(f"{n_tiles} tiles are not a multiple of align {align}")
        return [s * align for s in fetch_schedule(n_tiles // align, max_groups)]
    g = max(1, min(max_groups, n_tiles))
    q, r = divmod(n_tiles, g)
    return [q + 1] * r + [q] * (g - r)


def launch_groups(cfg: RenderConfig, n_tiles: int, align: int = 1) -> list:
    """Tile counts of the u32 frame's launch groups, in order: groups of
    `tiles_per_program` tiles where it cuts the frame; else the overlapped
    fetch's groups (JAX renderer.py:262-321): `fetch_schedule` under
    `fetch_taper`, a uniform `fetch_groups`-way split where it divides the
    tiles; else one group. `align` (a mesh's size) counts in units of that
    many tiles, so that every entry of the mesh has a tile in every group
    but the last, which takes what is left (JAX renderer.py:249-321 pads the
    frame instead)."""
    tpp, fg = cfg.tiles_per_program // align, cfg.fetch_groups
    n = -(-n_tiles // align)
    if cfg.tiles_per_program and tpp < n:
        tpp = max(tpp, 1)
        units = [min(tpp, n - s) for s in range(0, n, tpp)]
    elif fg > 1 and cfg.fetch_taper and n >= 2:
        units = fetch_schedule(n, max_groups=fg)
    elif fg > 1 and n >= fg and n % fg == 0:
        units = [n // fg] * fg
    else:
        units = [n]
    sizes = [u * align for u in units]
    sizes[-1] -= n * align - n_tiles
    return sizes


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


def build_frame_rays(cfg: RenderConfig, plan: FramePlan):
    """(o_all, d_all) each (n_tiles, pix_per_tile * U, 3) float32, pixels in
    tile-major order, AA samples consecutive per pixel; padding rays beyond
    the frame get a harmless +z direction."""
    H, W = cfg.height, cfg.width
    total_pixels = H * W
    U = plan.aa
    focus = np.asarray(cfg.camera.render_ray_focus, np.float32)
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    px = px.reshape(-1)[plan.order]
    py = py.reshape(-1)[plan.order]
    coords = pixel_scene_coords(cfg, px, py)
    dirs = (coords - focus[None, :]).astype(np.float32)

    n_rays = plan.n_tiles * plan.pix_per_tile * U
    o_all = np.zeros((n_rays, 3), np.float32)
    d_all = np.tile(np.float32([0, 0, 1]), (n_rays, 1))
    o_all[: total_pixels * U] = (
        coords[:, None, :] + plan.offsets[None, :, :]
    ).reshape(-1, 3)
    d_all[: total_pixels * U] = np.broadcast_to(
        dirs[:, None, :], (total_pixels, U, 3)
    ).reshape(-1, 3)
    T = plan.pix_per_tile * U
    return (
        o_all.reshape(plan.n_tiles, T, 3),
        d_all.reshape(plan.n_tiles, T, 3),
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


def _aa_reduce(color, valid, weights):
    """Weighted AA reduction of (n, U, 3) sample colours on the host (weights
    1/total, or multiplicity/total with dedupe; misses add black -- ref
    rs:1001-1015): the JAX package's numpy expression, so the same colours
    give the same bits. Returns ((n, 3) colour, (n,) any sample hit)."""
    return (
        np.where(valid[..., None], color, 0.0) * weights[None, :, None]
    ).sum(axis=1), valid.any(axis=1)


def _commit(buf: ImageBuffer, order, color, valid, weights) -> None:
    """Reduce n pixels' (n, U, 3) samples and write the pixels any sample hit
    into `buf` at the row-major indices `order` (n,) (ref
    raytracer_renderer.rs:918-1016)."""
    px_color, px_valid = _aa_reduce(color, valid, weights)
    idx = order[px_valid]
    buf.color.reshape(-1, 3)[idx] = px_color[px_valid]
    buf.valid.reshape(-1)[idx] = True


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
    PyTorch twins, as the tests do).

    With `cfg.devices` = N > 1 it renders on a mesh of N devices: the
    host's cards cuda:0 ... cuda:N-1 by default (RuntimeError when it has
    fewer), N CPU entries with `device="cpu"`, or the N devices of a list
    (`device=["cuda:0"] * N` splits one card N ways)."""

    def __init__(self, cfg: RenderConfig, device=None):
        if cfg.packet_mode and not cfg.anti_aliasing:
            # through the renderer a packet is the 8 AA lanes of one pixel;
            # without AA, 8 unrelated pixels would share their decisions
            raise ValueError("packet_mode requires anti_aliasing")
        self.mesh = mesh_of(cfg.devices, device) if cfg.devices > 1 else None
        self.device = self.mesh.lead if self.mesh else resolve_device(device)
        self.cfg = cfg
        # the last frame's ray counts (ops/trace.py::trace_rays, with_stats):
        # refused by a full pool or stack; left untraced at the iteration cap
        self.last_dropped = 0
        self.last_unfinished = 0

    def device_scene(self, scene: Scene) -> DeviceScene:
        if self.cfg.scene_backface_culling:
            scene = Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0]))
        return build_device_scene(scene, self.cfg, device=self.device)

    def render(
        self,
        scene: Scene,
        progress: Optional[Callable[[ImageBuffer, float], None]] = None,
    ) -> ImageBuffer:
        return self.render_device(self.device_scene(scene), progress)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    @functools.cached_property
    def frame_plan(self) -> FramePlan:
        """`plan_frame(cfg)`, built at its first use and kept: a renderer's
        config is fixed."""
        return plan_frame(self.cfg)

    @functools.cached_property
    def _frame_tables(self):
        """The u32 frame's tables on the (lead) device, uploaded at its first
        frame and kept: the tile-major pixel order padded with -1 to whole
        tiles (its first H*W entries are the order the pixels are scattered
        through), the AA offsets and the AA weights."""
        plan = self.frame_plan
        order, offsets = frame_order_device(self.cfg, plan, plan.n_tiles, self.device)
        return order, offsets, self._to_dev(plan.weights)

    def get_pixel_color(self, dscene: DeviceScene, x: int, y: int):
        """Single-pixel convenience (ref raytracer_renderer.rs:1140-1188):
        returns (linear RGB (3,) float32, valid) with AA when configured."""
        cfg = self.cfg
        plan = self.frame_plan
        coords = pixel_scene_coords(cfg, np.asarray([x]), np.asarray([y]))[0]
        direction = coords - np.asarray(cfg.camera.render_ray_focus, np.float32)
        o = coords[None, :] + plan.offsets
        d = np.broadcast_to(direction, (plan.aa, 3)).copy()
        color, valid = trace_rays(dscene, cfg, self._to_dev(o), self._to_dev(d))
        out, hit = _aa_reduce(color.cpu().numpy()[None], valid.cpu().numpy()[None], plan.weights)
        return out[0].astype(np.float32), bool(hit[0])

    def render_u32(self, dscene: DeviceScene) -> np.ndarray:
        """The frame as (H*W,) uint32 0xFFRRGGBB pixels, row-major; 0 marks a
        pixel no sample hit. Primary rays come from the device
        (`cfg.device_ray_gen`) or from the host (`build_frame_rays`), the
        same bits either way. The tiles are traced in `launch_groups`, whose
        pixels are fetched together at the end; on a mesh each group's tiles
        are split over its entries. Sets `last_dropped` and `last_unfinished`.

        The plan and its device tables are built at the renderer's first
        frame and kept (`frame_plan`). The tiles' pixels are scattered to
        row-major order on the device and fetched once.

        Records the frame's spans (`utils/timing.py`) while a torch profiler
        records: `frame`, and inside it `frame.plan` (the kept plan and
        tables, built in the first frame, and host-built rays; counters
        `aa_samples`, the AA table's rows or 1 without AA, `aa_distinct`, the
        samples traced a pixel, `rays`, the primary rays of every tile,
        padding included, and `pixels`), a `tile` per tile (ops/trace.py),
        `frame.reorder` (the device scatter and the counts' sums, enqueued)
        and `frame.fetch` (the host waiting for the device, then the copy
        back)."""
        spans.frame_recording()
        with spans.span("frame"):
            # the frame's host arrays are freed as `_frame_u32` returns: inside the span
            return self._frame_u32(dscene)

    def _frame_u32(self, dscene: DeviceScene) -> np.ndarray:
        """`render_u32`'s frame, inside its `frame` span."""
        cfg = self.cfg
        total_pixels = cfg.width * cfg.height
        with spans.span("frame.plan") as sp_plan:
            plan = self.frame_plan
            order_dev, offs_dev, w_dev = self._frame_tables
            n_tiles, P = plan.n_tiles, plan.pix_per_tile
            if spans.ON:
                sp_plan.counters.update(
                    aa_samples=cfg.total_aa_rays if cfg.anti_aliasing else 1,
                    aa_distinct=plan.aa, rays=n_tiles * P * plan.aa,
                    pixels=total_pixels)
            if not cfg.device_ray_gen:
                o_all, d_all = build_frame_rays(cfg, plan)
        reps = shard_scene(dscene, self.mesh) if self.mesh else None  # once a frame
        parts = []
        gs = 0
        for size in launch_groups(cfg, n_tiles, len(self.mesh) if self.mesh else 1):
            if cfg.device_ray_gen:
                args = (cfg, order_dev[gs * P:(gs + size) * P], offs_dev, w_dev)
                parts.append(
                    trace_tiles_sharded_u32_gen(reps, *args, self.mesh, n_tiles=size,
                                                with_stats=True) if reps
                    else trace_rays_tiled_u32_gen(dscene, *args, n_tiles=size, with_stats=True))
            else:
                args = (cfg, self._to_dev(o_all[gs:gs + size]),
                        self._to_dev(d_all[gs:gs + size]), w_dev)
                parts.append(trace_tiles_sharded_u32(reps, *args, self.mesh, with_stats=True)
                             if reps else trace_rays_tiled_u32(dscene, *args, with_stats=True))
            gs += size
        with spans.span("frame.reorder"):
            # the pixels scattered to row-major order on the device, wrapped to
            # int32 (the uint32 bits), the two counts' sums after them
            u32, dropped, unfinished = (torch.cat(p) for p in zip(*parts))
            out = torch.zeros((total_pixels + 2,), dtype=torch.int32, device=self.device)
            out[:total_pixels].index_copy_(0, order_dev[:total_pixels],
                                           u32.reshape(-1)[:total_pixels].to(torch.int32))
            out[total_pixels:] = torch.stack([dropped.sum(), unfinished.sum()])
        with spans.span("frame.fetch"):
            host = out.cpu().numpy()  # one fetch
        self.last_dropped = int(host[total_pixels])
        self.last_unfinished = int(host[total_pixels + 1])
        _warn_drops(self.last_dropped)
        return host[:total_pixels].view(np.uint32)

    def render_device(
        self,
        dscene: DeviceScene,
        progress: Optional[Callable[[ImageBuffer, float], None]] = None,
    ) -> ImageBuffer:
        cfg = self.cfg
        timing = RenderTiming()
        stats = TileStats()  # per-tile seconds (ref renderer/mod.rs:39-78)
        if progress is not None:
            buf = self._render_progressive(dscene, progress, timing, stats)
        elif cfg.device_encode and not cfg.render_timing_debug:
            buf = ImageBuffer.from_u32(self.render_u32(dscene), cfg.width, cfg.height)
        else:
            buf = self._render_f32(dscene, stats)
        timing.next()
        buf.timing = timing
        buf.tile_stats = stats
        if progress is not None and cfg.render_timing_debug:  # ref renderer/mod.rs:39-78
            stats.print()
        return buf

    def _render_f32(self, dscene: DeviceScene, stats: TileStats) -> ImageBuffer:
        """Host-built rays, traced `tiles_per_program` tiles at a time (all of
        them by default; on a mesh each group's tiles split over its entries,
        except under `render_timing_debug`), their f32 colours fetched per
        group and reduced on the host. `render_timing_debug` adds the drop
        warning. Sets `last_dropped` and `last_unfinished`; each group's seconds
        go to `stats`."""
        cfg = self.cfg
        plan = plan_frame(cfg)
        n_tiles, U = plan.n_tiles, plan.aa
        total_pixels = cfg.width * cfg.height
        o_all, d_all = build_frame_rays(cfg, plan)
        group = cfg.tiles_per_program or n_tiles
        # render_timing_debug times each group on the lead device alone
        # (the JAX package's mesh drops those stats instead)
        reps = (shard_scene(dscene, self.mesh)
                if self.mesh and not cfg.render_timing_debug else None)
        colors, valids, dropped, unfinished = [], [], 0, 0
        for gs in range(0, n_tiles, group):
            t_group = time.monotonic()
            args = (cfg, self._to_dev(o_all[gs : gs + group]),
                    self._to_dev(d_all[gs : gs + group]))
            c, v, st = (trace_tiles_sharded(reps, *args, self.mesh, with_stats=True) if reps
                        else trace_rays_tiled(dscene, *args, with_stats=True))
            colors.append(c.cpu().numpy())
            valids.append(v.cpu().numpy())
            dropped += int(st["dropped"])
            unfinished += int(st["unfinished"])
            stats.push(time.monotonic() - t_group)
        self.last_dropped, self.last_unfinished = dropped, unfinished
        if cfg.render_timing_debug:
            _warn_drops(dropped)
        buf = ImageBuffer(cfg.width, cfg.height)
        _commit(buf, plan.order, np.concatenate(colors).reshape(-1, U, 3)[:total_pixels],
                np.concatenate(valids).reshape(-1, U)[:total_pixels], plan.weights)
        return buf

    def _render_progressive(self, dscene, progress, timing, stats) -> ImageBuffer:
        """Per-tile launches committed as they finish (the reference's
        producer/consumer window, main.rs:330-347): each tile of the fused
        frame's host-built rays is traced, fetched once and committed through
        the tile-major permutation; then `progress(buf, share of pixels
        done)`. Sets `last_dropped` and `last_unfinished`."""
        cfg = self.cfg
        plan = plan_frame(cfg)
        U, P = plan.aa, plan.pix_per_tile
        total_pixels = cfg.width * cfg.height
        buf = ImageBuffer(cfg.width, cfg.height)
        o_all, d_all = build_frame_rays(cfg, plan)
        dropped = unfinished = 0
        for k in range(plan.n_tiles):
            t_tile = time.monotonic()
            start, end = k * P, min((k + 1) * P, total_pixels)
            n = end - start
            color, valid, st = trace_rays(
                dscene, cfg, self._to_dev(o_all[k]), self._to_dev(d_all[k]), with_stats=True
            )
            dropped += int(st["dropped"])
            unfinished += int(st["unfinished"])
            _commit(buf, plan.order[start:end], color.cpu().numpy()[: n * U].reshape(n, U, 3),
                    valid.cpu().numpy()[: n * U].reshape(n, U), plan.weights)
            if cfg.simulate_slow_render:  # ref renderer/mod.rs:126-129
                time.sleep(70e-6 * n)
            stats.push(time.monotonic() - t_tile)
            timing.next()
            progress(buf, end / total_pixels)
        self.last_dropped, self.last_unfinished = dropped, unfinished
        if cfg.render_timing_debug:
            _warn_drops(dropped)
        return buf
