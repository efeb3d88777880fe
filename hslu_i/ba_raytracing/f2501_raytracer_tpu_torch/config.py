"""Render configuration and camera constants.

TPU-native equivalent of the reference's *compile-time* configuration:

* resolution presets and env overrides   (ref: src/lib.rs:30-71)
* scene coordinate system + camera focus (ref: src/lib.rs:73-92)
* the 19 cargo feature flags             (ref: Cargo.toml:62-83)
* quality-tier derived constants         (ref: src/renderer/raytracer_renderer.rs:55-93)

Instead of `cfg!(feature = ...)` the flags live in a frozen, hashable
dataclass. This is the PyTorch port's copy: every field and derived
constant of the JAX package's config is kept so that the two packages read
the same configuration; the JAX-only `use_pallas` / `interpret` knobs are
gone because the tensor's device picks the implementation (CUDA kernel on
a CUDA tensor, plain PyTorch twin on a CPU tensor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# IoR of air (ref: src/lib.rs:92)
DEFAULT_REFRACTION_INDEX: float = 1.000293

# Resolution presets (ref: src/lib.rs:30-48)
RESOLUTION_SMALL: Tuple[int, int] = (768, 640)
RESOLUTION_MEDIUM: Tuple[int, int] = (1140, 950)
RESOLUTION_HIGH: Tuple[int, int] = (1620, 1350)


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Scene coordinate system derived from the window size.

    Mirrors the const-eval camera model of ref src/lib.rs:73-92: the scene is
    1.0 wide, `aspect` tall, and `(w+h)/2` window-pixels deep; primary rays
    fan out from a focus point 1.9 scene-depths behind the image plane.
    """

    width: int
    height: int

    @property
    def aspect(self) -> float:
        return float(self.height) / float(self.width)

    @property
    def scene_width(self) -> float:
        return 1.0

    @property
    def scene_height(self) -> float:
        return self.scene_width * self.aspect

    @property
    def scene_depth(self) -> float:
        return (self.scene_width + self.scene_height) / 2.0

    @property
    def average_scene_dimension(self) -> float:
        return (self.scene_width + self.scene_height + self.scene_depth) / 3.0

    @property
    def window_scene_depth(self) -> int:
        # ref: src/lib.rs:74
        return (self.width + self.height) // 2

    @property
    def w2s_width(self) -> float:
        return self.scene_width / float(self.width)

    @property
    def w2s_height(self) -> float:
        return self.scene_height / float(self.height)

    @property
    def w2s_depth(self) -> float:
        return self.scene_depth / float(self.window_scene_depth)

    @property
    def average_scene_factor(self) -> float:
        return (self.w2s_width + self.w2s_height + self.w2s_depth) / 3.0

    @property
    def render_ray_focus(self) -> Tuple[float, float, float]:
        # ref: src/lib.rs:88-89
        return (
            self.scene_width / 2.0,
            self.scene_height / 2.0,
            -1.9 * self.scene_depth,
        )

    @property
    def epsilon_distance(self) -> float:
        # ref: src/vector.rs:697-699 — f32::EPSILON * 100 * AVERAGE_SCENE_DIMENSION
        return float(2.0**-23) * 100.0 * self.average_scene_dimension


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Feature flags + engine knobs. Hashable; used as a jit-static argument.

    Flag semantics mirror ref Cargo.toml:62-83; derived quality constants
    mirror ref src/renderer/raytracer_renderer.rs:55-93.
    """

    width: int = RESOLUTION_MEDIUM[0]
    height: int = RESOLUTION_MEDIUM[1]

    # feature flags (ref Cargo.toml:62-83)
    anti_aliasing: bool = False
    anti_aliasing_rotation_scale: bool = False
    anti_aliasing_randomness: bool = False
    soft_shadows: bool = False
    reflections: bool = False
    light_reflections: bool = False  # declared in the reference, never consulted
    refractions: bool = False
    backface_culling: bool = False  # runtime dot<0.75 cull quirk
    scene_backface_culling: bool = False  # static host-side cull
    high_quality: bool = False
    extreme_quality: bool = False
    high_quality_model: bool = False

    # determinism: the reference draws fresh Poisson jitter per process (AA)
    # and per *pixel* (light clouds); we precompute deterministically.
    seed: int = 0

    # dev toggles mirrored from the reference's cargo features
    # (ref Cargo.toml:66-67): slow-render makes progressive preview visible,
    # timing-debug prints per-tile stats after the render
    simulate_slow_render: bool = False
    render_timing_debug: bool = False

    # AA direction-cycling width: the reference's scalar build (its default)
    # restarts the 8-direction cycle every packet, so packet width 1 means
    # every sample uses direction 0; the simd_render build cycles all 8
    # (ops/camera.py). 1 reproduces the golden image's build.
    aa_packet_lanes: int = 1
    # Full simd_render packet semantics (ref raytracer_renderer.rs:1190-1357
    # dispatch): groups of 8 consecutive AA rays form one packet whose
    # reflection/refraction SPAWN decisions are packet-wide `.any()`s
    # (rs:217, rs:232, rs:584-594, rs:306-308), whose depth budgets are one
    # scalar per packet, and whose adaptive refraction step/divisor derive
    # from the packet-horizontal-max opacity (rs:458-491). Per-lane
    # contributions stay masked exactly as the reference's final blends
    # (rs:712-729, rs:505-522). Requires anti_aliasing (packets = the 8 AA
    # lanes of one pixel) and disables resort_secondary.
    packet_mode: bool = False

    # engine knobs (TPU-side; no reference equivalent)
    tile_rays: int = 8192  # rays per traced batch
    stack_size: int = 24  # wavefront DFS stack slots (>= max depth + 1)
    max_nodes: int = 96  # shading-tree nodes evaluated per ray, upper bound
    # secondary-ray compaction: each loop iteration services only
    # tile_rays/compaction_ratio pixels with pending rays (sorted to the
    # front), since contributions are weight-linear and order-independent.
    # 1 disables compaction; measured sweet spot ~32 on v5e (PERF.md).
    compaction_ratio: int = 32
    weight_cutoff: float = 1e-4  # prune children with weight below this
    # iterations per while-loop step: a data-dependent while_loop syncs with
    # the host every iteration on remote-attached TPUs (~10-45 ms each!);
    # running loop_chunk fori iterations per while step amortizes the sync
    # while keeping the early exit (an all-dead iteration is a cheap no-op)
    loop_chunk: int = 128
    # Morton-resort each serviced pool batch for kernel-tile ray coherence
    # (measured neutral-to-slightly-negative on semesterbild; off by default)
    resort_secondary: bool = False
    # triangles per Morton block (the culling/pair-math granularity).
    # 0 = auto by measured regime (PERF.md sweeps): hq-mesh scenes run the
    # light kernel 1.5-1.6x faster at 256 than at 64/512; plain scenes want
    # fine 64 blocks at >=1e6-pixel frames (deep secondary wavefronts) and
    # coarse 512 on small frames. resolve: scene/device.py::_resolve_block
    triangle_block: int = 0
    # rays per Pallas kernel instance (the kernel grid is R // kernel_ray_tile
    # sequential instances). Larger tiles amortize VPU instruction-issue
    # overhead on the flat (RT,)-wide shading ops (~4x fewer instances at
    # 1024) at the cost of coarser per-tile AABB culling granularity and more
    # VMEM per pair intermediate (RT x triangle_block f32).
    kernel_ray_tile: int = 256
    # kernel ray tile for the POOL phase's serviced secondary wavefronts
    # (0 = same as kernel_ray_tile): secondaries are less coherent (lane
    # utility 54% vs 67% inside executed gate triples, PERF.md), so a finer
    # tile can gate better there while primaries keep the wide optimum
    pool_ray_tile: int = 0
    # pool staging-compaction machinery ("scatter" | "gather" | "unique"):
    # how candidate child rows compact into the dense ray pool. The modes
    # are output-identical; they differ only in which XLA op pays the
    # per-row cost (row scatter vs searchsorted+row gather vs a
    # unique-declared scatter into a 2x buffer). See ops/trace.py
    # _pool_append and the A/B in scripts/tpu_stage_ab.py.
    stage_mode: str = "scatter"
    # packed pool-row kernel epilogue (round 5): on the fused-eligible
    # pool path the shade+eval kernel writes each child's (T, 16)
    # POOL_COLS staging rows directly (pallas_shade_eval_rows), removing
    # the per-field transposes + _pack_entry concats between the kernel
    # and the staging scatter. Bit-identical to the unpacked path
    # (tests/test_packed_rows.py); False restores the per-field outputs.
    packed_stage: bool = True
    # split the per-chunk contribution commit into this many cond-gated
    # segment scatter-adds: the staging buffer is sized for the full
    # loop_chunk but typical tiles execute only a prefix of it, and
    # scatter-add cost is ~per-row — gated segments skip the unexecuted
    # suffix exactly (ops/trace.py). 1 = single commit (legacy).
    # NOTE: the split count must divide loop_chunk; a value that doesn't is
    # coerced DOWN to the largest divisor (e.g. 5 -> 4, 7 -> 1 at
    # chunk=128) — see ops/trace.py::_run_pool.
    commit_splits: int = 1
    # shadow-pack Morton-block scan order ("camera" | "light"): "light"
    # scans blocks nearest the lights first within each trans/opaque
    # section, saturating per-lane opacity sooner for the LANE_GATE
    # evolving gate (scene/device.py). Semantically order-free — shadow
    # accumulation is a sum/max over blocks — but the f32 sum ORDER
    # changes, so outputs are allclose, not bit-identical
    # (scripts/tpu_shadoworder_ab.py).
    shadow_order: str = "camera"
    # Morton blocks per superblock AABB (two-level shadow/cast culling);
    # 0 = the build default (8)
    superblock: int = 0
    # logical ray-pool capacity override (rows). 0 = auto: sized from the
    # LIFO/DFS depth bound so a healthy trace can never saturate
    # (ops/trace.py::_run_pool). Nonzero caps the LOGICAL entry count
    # (clamped into [2W, auto]; the physical buffer keeps the auto size for
    # slice legality) and exists for drop-audit tests: an undersized pool
    # truncates pending secondary rays from the LIFO top, which every
    # production path counts and reports (the reference recursion never
    # drops subtrees, raytracer_renderer.rs:216-248).
    pool_capacity: int = 0
    # triangle count beyond which the scene SoA stops being VMEM-resident
    # and the cast/occlude kernels stream Morton blocks from HBM instead
    # (~100 bytes/triangle resident; ~8 MB at the default threshold)
    stream_triangles: int = 81920
    # fused-frame chunking: 0 = whole frame as one program (fastest);
    # N > 0 caps each launched program at N tiles. Heavy configs (AA x
    # soft-shadow clouds x hq mesh) can run many minutes in one program,
    # which the remote-relay worker watchdog kills — cap them.
    tiles_per_program: int = 0
    # overlapped fetch: split the fused u32 frame into N programs, dispatch
    # them ALL, then fetch in order — group g's host fetch rides while g+1
    # computes. On the remote relay this cut the 1080p wall 810 -> 718 ms
    # same-session (scripts/tpu_overlap_bench.py; 16 tiles in 8 groups of 2
    # is the measured optimum with the 131072-ray tile default). Applies
    # when it divides the frame's tile count; single-chip u32 path only
    # (tiles_per_program and mesh mode must sync between launches instead).
    # 1 = off (one program, fetch after).
    fetch_groups: int = 8
    # front-loaded (tapered) fetch schedule: the exposed wall tail is the
    # LAST group's host fetch, so late groups shrink to 1 tile and early
    # groups grow (their fetches hide under more remaining compute) —
    # same-session 725 vs 740 ms at 1080p/16 tiles vs uniform G=8
    # (scripts/tpu_overlap_bench.py taper mode). Also lifts the
    # divisibility requirement (any tile count >= 2 overlaps). False =
    # uniform fetch_groups-way split as before.
    fetch_taper: bool = True
    # devices > 1 shards the frame's tile axis over a jax.sharding.Mesh:
    # each chip traces its local tiles (scene replicated, rays data-parallel,
    # SURVEY.md §2.3); outputs stay device-sharded for host assembly
    devices: int = 1
    # fold identical AA samples into one weighted ray: the reference's AA
    # table starts [0,0] + 8x[1,1] (raytracer_renderer.rs:105-127) and the
    # scalar build biases every sample along direction 0 (aa_packet_lanes=1),
    # so those 8 rows are the SAME ray — tracing it once with weight 8/total
    # is algebraically exact (contributions are weight-linear). Ignored in
    # packet_mode (packets need the full 8-lane layout).
    dedupe_aa: bool = True
    # encode finished pixels to packed 0xFFRRGGBB u32 ON DEVICE (the
    # reference's ImageBuffer<AtomicU32> format, image_buffer.rs:10-15): the
    # AA reduction + u8 quantization fuse into the frame program and the
    # host fetches 4 bytes/pixel instead of 12·aa — on remote-attached TPUs
    # the f32 fetch is a measurable share of frame latency (PERF.md).
    # Invalid pixels encode as 0x00000000 (alpha 0 = never written).
    device_encode: bool = False
    # generate primary rays ON DEVICE from the compact tile-major pixel
    # permutation (4 B/pixel uploaded once) instead of host-built (o, d)
    # buffers (24·U B/pixel — ~0.9 GB at extreme AA): rays are affine in
    # the pixel index, so the frame program rebuilds them bit-identically
    # (ops/trace.py::trace_rays_tiled_u32_gen). Applies to the overlapped
    # u32 fetch path; other paths keep the host build.
    device_ray_gen: bool = True

    def __post_init__(self):
        if self.anti_aliasing_rotation_scale or self.anti_aliasing_randomness:
            object.__setattr__(self, "anti_aliasing", True)
        if self.extreme_quality:
            object.__setattr__(self, "high_quality", True)
        if self.high_quality:
            object.__setattr__(self, "anti_aliasing", True)
            object.__setattr__(self, "soft_shadows", True)
            object.__setattr__(self, "high_quality_model", True)
        # typo guard: an unknown mode would silently fall into a default
        # branch downstream, hiding misconfigured A/B runs
        if self.stage_mode not in ("scatter", "gather", "unique"):
            raise ValueError(
                f"stage_mode must be one of scatter|gather|unique, "
                f"got {self.stage_mode!r}"
            )
        if self.shadow_order not in ("camera", "light"):
            raise ValueError(
                f"shadow_order must be camera|light, got {self.shadow_order!r}"
            )

    @property
    def uses_hq_mesh(self) -> bool:
        """The reference loads the high-quality text mesh when the
        high_quality_model OR medium_resolution feature is set (ref
        src/main.rs:30-35) — shared by the OBJ path choice
        (models/semesterbild.py) and the triangle-block auto-resolver
        (scene/device.py::_resolve_block) so a default-resolution scene
        gets the measured-optimal hq-mesh block size."""
        return (
            self.high_quality_model
            or (self.width, self.height) == RESOLUTION_MEDIUM
        )

    # ---- derived quality constants ----

    @property
    def camera(self) -> CameraSpec:
        return CameraSpec(self.width, self.height)

    @property
    def reflection_max_depth(self) -> int:
        # ref: raytracer_renderer.rs:55-63
        if self.high_quality:
            return 21 if self.extreme_quality else 13
        return 9

    @property
    def refraction_max_depth(self) -> int:
        # ref: raytracer_renderer.rs:65-73
        if self.high_quality:
            return 21 if self.extreme_quality else 18
        return 8

    @property
    def point_light_multiplicator(self) -> int:
        # ref: raytracer_renderer.rs:75-87
        if not self.soft_shadows:
            return 1
        if self.high_quality:
            return 28 if self.extreme_quality else 19
        return 10

    @property
    def antialiasing_samples_per_pixel(self) -> int:
        # ref: raytracer_renderer.rs:89-93
        return 24 if self.extreme_quality else 9

    @property
    def total_aa_rays(self) -> int:
        # next multiple of the 8-wide packet (ref: raytracer_renderer.rs:1018-1020)
        n = self.antialiasing_samples_per_pixel
        return ((n + 7) // 8) * 8

    @property
    def realistic(self) -> bool:
        return self.reflections and self.refractions

    # ---- preset constructors (BASELINE.json "configs") ----

    @classmethod
    def default_scene(cls, width=None, height=None, **kw) -> "RenderConfig":
        """primary rays + Blinn-Phong + hard shadows (plain `cargo run`
        with default-features disabled)."""
        w, h = width or RESOLUTION_SMALL[0], height or RESOLUTION_SMALL[1]
        return cls(width=w, height=h, **kw)

    @classmethod
    def reference_default(cls, width=None, height=None, **kw) -> "RenderConfig":
        """The reference's `default` cargo feature set (ref Cargo.toml:64):
        realistic + scene_backface_culling + AA(rotation+randomness)
        + medium_resolution + high_quality."""
        w, h = width or RESOLUTION_MEDIUM[0], height or RESOLUTION_MEDIUM[1]
        return cls(
            width=w,
            height=h,
            reflections=True,
            light_reflections=True,
            refractions=True,
            scene_backface_culling=True,
            anti_aliasing_rotation_scale=True,
            anti_aliasing_randomness=True,
            high_quality=True,
            **kw,
        )

    @classmethod
    def realistic_scene(cls, width=None, height=None, **kw) -> "RenderConfig":
        """reflections + light_reflections + refractions, hard shadows."""
        w, h = width or RESOLUTION_SMALL[0], height or RESOLUTION_SMALL[1]
        return cls(
            width=w,
            height=h,
            reflections=True,
            light_reflections=True,
            refractions=True,
            **kw,
        )

    def feature_string(self) -> str:
        """Config banner (ref: src/output/mod.rs:25-88)."""
        aa = "Non-Antialiasing"
        if self.anti_aliasing:
            parts = ["Antialiasing"]
            if self.anti_aliasing_rotation_scale:
                parts.append("ROS_SCL")
            if self.anti_aliasing_randomness:
                parts.append("RNG")
            aa = " ".join(parts)
        if self.reflections or self.refractions:
            real = "Reflections + Refractions" if self.refractions else "Reflections"
        else:
            real = "Non-Realistic"
        if self.high_quality:
            quality = "Extreme Quality" if self.extreme_quality else "High Quality"
        else:
            quality = "Standard Quality"
        if (self.width, self.height) == RESOLUTION_HIGH:
            res = "High Resolution"
        elif (self.width, self.height) == RESOLUTION_MEDIUM:
            res = "Medium Resolution"
        else:
            res = "Small Resolution"
        cam = self.camera
        return " | ".join(
            [
                "SIMD",
                aa,
                real,
                f"{quality} ({self.width}×{self.height}×{cam.window_scene_depth})",
                "Backface Culling" if self.backface_culling else "NO-OPT",
            ]
        )
