"""The port's hand-written CUDA kernels, their wrappers and plain twins.

Seven kernels, each replacing one Pallas kernel of the JAX package
(ops/pallas_kernels.py):

* `cast_triangles`  <- `_cast_kernel` / `pallas_cast_triangles` (every
  resident path)
* `cast_triangles_stream` <- `_cast_stream_kernel` /
  `pallas_cast_triangles_stream` (the cast of a streamed scene)
* `occlude_triangles_stream` <- `_occl_stream_kernel` /
  `pallas_occlude_triangles_stream` (the lighting of a streamed scene)
* `occlude_triangles` <- `_occlude_kernel` / `pallas_occlude_triangles`
  (`occlude_rays` on a resident scene)
* `shade_eval_rows` <- `_shade_eval_kernel(packed_rows=True)` /
  `pallas_shade_eval_rows` (the packed-row pool path)
* `shade_eval`      <- `_shade_eval_kernel(packed_rows=False)` /
  `pallas_shade_eval` (the per-ray stack path, `packed_stage=False`)
* `light_shade`     <- `_light_shade_kernel` / `pallas_light_shade`
  (configs without reflections or refractions)

and three that replace none: the glue of a pool iteration on the card
(`GLUE_KERNELS`; the JAX package leaves it to XLA), `pool_take`,
`pool_hit` and `pool_put` around `cast_triangles` and `shade_eval_rows`
(ops/trace.py::_pool_loop). `pool_put` updates its arguments in place
(`IN_PLACE`); every other wrapper returns new tensors.

Sources are `csrc/*.cu` (CUDA C++ for sm_90a with a plain C interface); the
three shading kernels share the device code of `rt_light.cuh` and
`rt_node.cuh`, and they and the two occlusion kernels that of
`rt_occlude.cuh`.
They are built with nvcc on first use into `build/torch_kernels/` at the
repository root (keyed by a hash of the sources and flags; one nvcc per
source, all started together) and loaded with ctypes. Each kernel launches
on the current stream of its tensors' device, which must be the current
device, and its C entry point returns `cudaGetLastError()`; the wrapper
raises if that is not 0. Wrappers may be called from several host threads
at once (a mesh runs one per entry, parallel/mesh.py).

The device of the input tensors picks the implementation: a CUDA tensor
goes to the kernel (or the call raises); a CPU tensor goes to the plain
PyTorch twin (`*_plain`), which the CPU tests hold against the JAX package.
`LAUNCHES` counts kernel launches (twin calls are not counted; `pool_put`
once a fused pool iteration), and under
LIGHT_LANES_LAUNCHES the `shade_eval_rows` launches that took its
light-lanes form (`node_form`): a launch recorded into a CUDA graph counts
when the graph is replayed (`counting_into`, `count_launches`; ops/trace.py's
pool chunks).

The shadow scan of the three shading kernels walks the Morton blocks in
storage order (csrc/rt_light.cuh).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .intersect import (
    BIG_IDX,
    _add_pack_occlusion,
    _hit_record,
    _homogeneous,
    _pack_nearest,
    _sphere_nearest_of,
)
from .shading import ambient, light_sums
from .trace import (
    POOL_COLS,
    _active_hit,
    _hit_fields,
    _node_children,
    _pack_entry,
    _park,
    _pool_put,
    _pool_window,
    _unpack_entry,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_PKG))), "build", "torch_kernels"
)
KERNEL_SOURCES = {
    "cast_triangles": "cast_triangles.cu",
    "cast_triangles_stream": "cast_triangles_stream.cu",
    "occlude_triangles_stream": "occlude_triangles_stream.cu",
    "occlude_triangles": "occlude_triangles.cu",
    "shade_eval_rows": "shade_eval_rows.cu",
    "shade_eval": "shade_eval.cu",
    "light_shade": "light_shade.cu",
    "pool_take": "pool_take.cu",
    "pool_hit": "pool_hit.cu",
    "pool_put": "pool_put.cu",
}
# the kernels of the pool iteration's glue, which replace no TPU kernel
GLUE_KERNELS = ("pool_take", "pool_hit", "pool_put")
# wrappers that update their tensor arguments in place (ops/trace.py's chunk
# graphs call a swapped one on the arguments themselves, not on copies)
IN_PLACE = ("pool_put",)
COMMON_HEADERS = ("rt_common.cuh", "rt_occlude.cuh", "rt_light.cuh", "rt_node.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the key of LAUNCHES that counts shade_eval_rows' light-lanes launches
LIGHT_LANES_LAUNCHES = "shade_eval_rows.light_lanes"
LAUNCHES = {**{name: 0 for name in KERNEL_SOURCES}, LIGHT_LANES_LAUNCHES: 0}

# the builds, the loaded libraries, LAUNCHES and the tables' caches
_lock = threading.Lock()
_libs: dict = {}
_capture = threading.local()  # `launches`: the open capture's counts on this thread


def reset_launch_counts() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


@contextlib.contextmanager
def counting_into(counts):
    """While inside, this thread's launches count in the dict `counts`, not
    in LAUNCHES: they are being captured into a CUDA graph and run only when
    it is replayed, and each replay adds `counts` (`count_launches`). With
    None they count in LAUNCHES again (an eager call between two graphs of
    a capture)."""
    saved = getattr(_capture, "launches", None)
    _capture.launches = counts
    try:
        yield counts
    finally:
        _capture.launches = saved


def count_launches(counts: dict) -> None:
    with _lock:
        for k, n in counts.items():
            LAUNCHES[k] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNEL_SOURCES[name],) + COMMON_HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_kernels(names=None) -> dict:
    """Build every missing kernel library, one nvcc per source, all started
    together. Returns {name: {"seconds": float, "ptxas": str, "cached": bool}}
    (ptxas -v output: registers, shared memory and spills per kernel)."""
    names = list(names or KERNEL_SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    t0 = time.monotonic()
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            ptxas = ""
            if os.path.exists(so + ".log"):
                with open(so + ".log") as fh:
                    ptxas = fh.read()
            out[name] = dict(seconds=0.0, cached=True, ptxas=ptxas)
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, KERNEL_SOURCES[name])]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        with open(so + ".log", "w") as fh:
            fh.write(log)
        os.replace(tmp, so)  # atomic: concurrent builders race safely
        out[name] = dict(seconds=time.monotonic() - t0, cached=False, ptxas=log)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return out


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# scene tables of the shading kernels: lights, n_lights, sph, S, trb, P,
# trans_rows, blk, blk_aabb, nb, B, n_trans_blocks
_SCENE = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I]
_ARGTYPES = {
    # o, d, R, trb, P, pack, nb, B, aabb, saabb, sb_start, nsb, sb_shift,
    # rays_per_warp, backface, t, idx, stream
    "cast_triangles": ("rt_cast_triangles", [
        _P, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]),
    # o, d, R, pack, nb, B, aabb, saabb, sb_start, nsb, sb_shift, rays_per_warp,
    # backface, t, idx, stream
    "cast_triangles_stream": ("rt_cast_triangles_stream", [
        _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]),
    # o, d, maxd, R, pack, nb, B, aabb, saabb, sb_start, nsb, sb_shift, rays_per_warp,
    # block_httr, backface, dec, opq, fsub, stream
    "occlude_triangles_stream": ("rt_occlude_triangles_stream", [
        _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P]),
    # o, d, maxd, R, trb, P, bigtri_trans, pack, nb, B, aabb, saabb, sb_start,
    # nsb, sb_shift, rays_per_warp, block_httr, backface, dec, opq, fsub, stream
    "occlude_triangles": ("rt_occlude_triangles", [
        _P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P,
        _P]),
    "shade_eval_rows": ("rt_shade_eval_rows", [
        *_SCENE, _P, _P, _I, _I, _I,  # the gate's superblocks, the form
        *([_P] * 17), _I,  # per-ray fields, R
        _F, _I, _I, _I, _I, _I, _F, _F,  # node constants
        *([_P] * 6)]),  # 5 outputs, stream
    "shade_eval": ("rt_shade_eval", [
        *_SCENE, _P, _P, _I, _I, _I,  # the gate's superblocks, warp_max_live
        *([_P] * 16), _I,  # per-ray fields, R
        _F, _I, _I, _I, _I, _I, _F, _F,  # node constants
        _P, *([_P] * 13)]),  # scratch, 12 outputs, stream
    # scene, 6 per-ray inputs, R, eps, backface, 2 outputs, stream
    "light_shade": ("rt_light_shade", [
        *_SCENE, *([_P] * 6), _I, _F, _I, _P, _P, _P]),
    # pool, count, W, o, d, w, ior, budget, from_refl, pix, take, stream
    "pool_take": ("rt_pool_take", [_P, _P, _I, *([_P] * 8), _P]),
    # sph, S, mat, o, d, tt, tidx, take, W, backface, 11 outputs, stream
    "pool_hit": ("rt_pool_hit", [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, *([_P] * 11), _P]),
    # pool, Q, Q_cap, count, dropped, stage_pix, stage_contrib, take, pix,
    # contrib, rows_a, mask_a, rows_b, mask_b, k, W, slot, R, stream
    "pool_put": ("rt_pool_put", [_P, _L, _L, *([_P] * 11), _I, _I, _I, _L, _P]),
}


def _fn(name: str):
    with _lock:
        if name not in _libs:
            missing = [n for n in KERNEL_SOURCES if not os.path.exists(_so_path(n))]
            if missing:
                build_kernels(missing)
            lib = ctypes.CDLL(_so_path(name))
            sym, argtypes = _ARGTYPES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return _libs[name]


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(dev, name, *args):
    """Launch kernel `name` on the current stream of `dev`, the device of
    the call's tensors, which must be the current device: a launch runs on
    the current device whatever its pointers say. Callable from several
    host threads at once (one per device or stream of a mesh)."""
    if torch.cuda.current_device() != dev.index:
        raise RuntimeError(f"{name}: tensors on {dev}, but the current device is "
                           f"cuda:{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    _count(name)


def _count(key):
    """One launch under `key`: into the open capture's counts on this
    thread, else into LAUNCHES."""
    counts = getattr(_capture, "launches", None)
    with _lock:
        if counts is None:
            LAUNCHES[key] += 1
        else:
            counts[key] = counts.get(key, 0) + 1


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# cast_triangles  (TPU: pallas_kernels.py::_cast_kernel, line 301)
# ---------------------------------------------------------------------------

_sb_cache: dict = {}


def _sb_start(sb_sizes, nb, device):
    """Superblock start offsets (n_groups + 1,) int32 on the device, cached:
    building them per call would cost a host-to-device copy each time."""
    key = (tuple(sb_sizes), nb, str(device))
    with _lock:
        if key not in _sb_cache:
            sizes = list(sb_sizes) or [1] * nb
            if sum(sizes) != nb:
                raise ValueError(f"superblock sizes {sizes} do not cover {nb} blocks")
            starts = [0]
            for n in sizes:
                starts.append(starts[-1] + n)
            _sb_cache[key] = torch.tensor(starts, dtype=torch.int32, device=device)
        return _sb_cache[key]


def _nearest_over_blocks(best_t, best_idx, tri_cast_pack, base, o4, d, backface_culling):
    """Fold the Morton blocks of `tri_cast_pack` into a running nearest hit,
    in order and with a strict `<` (an earlier block keeps a tie); slot
    (b, c) gets the index base + b*B + c. The JAX `_tri_nearest_xla` scan."""
    B = tri_cast_pack.shape[1]
    for b, block in enumerate(tri_cast_pack):
        tmin, targ = _pack_nearest(block, o4, d, backface_culling)
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_idx = torch.where(closer, base + b * B + targ, best_idx)
    return best_t, best_idx.to(torch.int32)


def cast_triangles_plain(trb_pack, tri_cast_pack, o, d, backface_culling=False):
    """Plain twin of the cast kernel: the JAX plain path's big-primitive and
    Morton-block nearest hits (`_bigtri_nearest_xla`, `_tri_nearest_xla`),
    over the same packs and in the kernel's index space (big primitive
    p -> p, Morton slot (b, c) -> P + b*B + c; miss: +inf, 2^31-1). No AABB
    gate: the kernel's widened gate never changes the result."""
    o4 = _homogeneous(o)
    best_t, bidx = _pack_nearest(trb_pack, o4, d, backface_culling)
    best_idx = torch.where(torch.isfinite(best_t), bidx, torch.full_like(bidx, BIG_IDX))
    return _nearest_over_blocks(best_t, best_idx, tri_cast_pack, trb_pack.shape[0], o4, d,
                                backface_culling)


def cast_triangles(trb_pack, tri_cast_pack, tri_aabb, tri_saabb, o, d, *, sb_sizes,
                   backface_culling=False):
    """Nearest triangle hit of R rays over the big-primitive pack and the
    Morton blocks of a resident scene: (t (R,) f32, idx (R,) int32) in the
    TPU kernel's local index space (see `cast_triangles_plain`). `tri_saabb`,
    `sb_sizes`: the scene's superboxes and their partition of the blocks."""
    R, dev = _check_rays("cast_triangles", o, d)
    P = trb_pack.shape[0]
    _check(trb_pack, "trb_pack", torch.float32, (P, 32), dev)
    nb, B = _check_block_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes, dev)
    if dev.type == "cpu":
        return cast_triangles_plain(trb_pack, tri_cast_pack, o, d, backface_culling)
    _check_big_rows(trb_pack)
    sb, nsb, sb_shift = _warp_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes,
                                     trb_pack=trb_pack)
    t_out = torch.empty((R,), dtype=torch.float32, device=dev)
    idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
    _launch(dev,
        "cast_triangles", _ptr(o), _ptr(d), R, _ptr(trb_pack), P, _ptr(tri_cast_pack), nb, B,
        _ptr(tri_aabb), _ptr(tri_saabb), _ptr(sb), nsb, sb_shift, rays_per_warp(R, many=32),
        int(bool(backface_culling)), _ptr(t_out), _ptr(idx_out),
    )
    return t_out, idx_out


# ---------------------------------------------------------------------------
# cast_triangles_stream  (TPU: pallas_kernels.py::_cast_stream_kernel, line 473)
# ---------------------------------------------------------------------------


def cast_triangles_stream_plain(tri_cast_pack, o, d, backface_culling=False):
    """Plain twin of the streamed cast kernel: the JAX plain path's
    Morton-block nearest hit (`_tri_nearest_xla`) over the blocks of
    `tri_cast_pack` in order, strict `<` across blocks, in the kernel's
    index space (slot (b, c) -> b*B + c; miss: +inf, 2^31-1). No AABB gate:
    the kernel's widened gate never changes the result."""
    R = o.shape[0]
    best_t = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
    best_idx = torch.full((R,), BIG_IDX, dtype=torch.int64, device=o.device)
    return _nearest_over_blocks(best_t, best_idx, tri_cast_pack, 0, _homogeneous(o), d,
                                backface_culling)


def _check_rays(name, o, d, max_distance=None):
    """Check the per-ray inputs of a cast or occlusion kernel; returns
    (R, device)."""
    R = o.shape[0]
    dev = o.device
    _check(o, "o", torch.float32, (R, 3), dev)
    _check(d, "d", torch.float32, (R, 3), dev)
    if max_distance is not None:
        _check(max_distance, "max_distance", torch.float32, (R,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return R, dev


def _check_block_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes, dev):
    """Check the Morton-block tables of a cast or streamed kernel: the
    blocks, their boxes, and the superboxes over `sb_sizes` consecutive
    blocks each. Returns (nb, B)."""
    nb, B, _ = tri_cast_pack.shape
    _check(tri_cast_pack, "tri_cast_pack", torch.float32, (nb, B, 32), dev)
    _check(tri_aabb, "tri_aabb", torch.float32, (nb, 8), dev)
    _check(tri_saabb, "tri_saabb", torch.float32, (len(sb_sizes), 8), dev)
    if sum(sb_sizes) != nb or min(sb_sizes, default=1) < 1:
        raise ValueError(f"superblock sizes {tuple(sb_sizes)} do not cover {nb} blocks")
    return nb, B


# Below this many rays (a wavefront of the pool) every ray needs a warp of
# its own to fill the card. From here on a warp takes `many` rays: the
# streamed kernels 8, so that every SM of an H100 still has 32 warps (8 *
# 132 SMs * 32 warps) and a block's rows are loaded once for 8 rays; the
# resident kernels 32, a ray per lane, whose coherent rays walk the same
# rows at once.
PACKET_MIN_RAYS = 8 * 132 * 32


def rays_per_warp(n_rays: int, many: int = 8) -> int:
    return many if n_rays >= PACKET_MIN_RAYS else 1


# From this many lights on, a wavefront of shade_eval_rows (fewer than
# PACKET_MIN_RAYS rays) takes the light-lanes form: a warp per ray whose
# lanes take its lights, each scanning a shadow ray alone, where the form
# with a warp per ray walks a ray's lights one after another, its lanes
# sharing each light's scan. Set from device times of the three forms at
# W = 2048 and 3584 and 5 to 140 lights on an H100 (PERF.md, kernel #6).
LIGHT_LANES_MIN_LIGHTS = 16
# shade_eval_rows' form code of the light-lanes form (csrc RT_LIGHT_LANES)
LIGHT_LANES = 0


def node_form(n_rays: int, n_lights: int) -> int:
    """The form of a shade_eval_rows call: 32 (a ray per lane) from
    PACKET_MIN_RAYS rays on; below, LIGHT_LANES from LIGHT_LANES_MIN_LIGHTS
    lights on, else 1 (a warp per ray, its lanes sharing each shadow scan)."""
    k = rays_per_warp(n_rays, many=32)
    return LIGHT_LANES if k == 1 and n_lights >= LIGHT_LANES_MIN_LIGHTS else k


def _warp_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes, **more):
    """What the warp-per-ray kernels need beyond the checked shapes: tables
    aligned for 16-byte loads (the block tables and `more`). They take any
    partition: blocks of any row count (a ragged last round of rows) and
    superblocks of any size (more than 32 blocks in rounds of 32 lanes).
    Returns (superblock starts on the device, number of superblocks, log2 of
    the largest superblock's size, rounded up)."""
    nb = tri_cast_pack.shape[0]
    for name, t in (("tri_cast_pack", tri_cast_pack), ("tri_aabb", tri_aabb),
                    ("tri_saabb", tri_saabb), *more.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not aligned to 16 bytes")
    largest = max(sb_sizes, default=1)  # no superblocks: a scene without blocks
    return (_sb_start(sb_sizes, nb, tri_cast_pack.device), len(sb_sizes),
            (largest - 1).bit_length())


# Rows of the big-primitive pack that the resident kernels with a warp per
# ray stage in shared memory: the cap that scene/device.py puts on that pack
# (BIGTRI_CAP).
BIG_ROWS = 128


def _check_big_rows(trb_pack):
    if trb_pack.shape[0] > BIG_ROWS:
        raise ValueError(f"trb_pack: {trb_pack.shape[0]} big-primitive rows; the kernel "
                         f"stages at most {BIG_ROWS}")


def cast_triangles_stream(tri_cast_pack, tri_aabb, tri_saabb, o, d, *, sb_sizes,
                          backface_culling=False):
    """Nearest Morton-slot hit of R rays over the blocks of `tri_cast_pack`
    (nb, B, 32), for scenes past `stream_triangles`: (t (R,) f32, local slot
    (R,) int32), the port's `pallas_cast_triangles_stream`. `tri_saabb`,
    `sb_sizes`: the scene's superboxes and their partition of the blocks, as
    `cast_triangles` takes them. The caller folds in spheres and big
    primitives."""
    R, dev = _check_rays("cast_triangles_stream", o, d)
    nb, B = _check_block_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes, dev)
    if dev.type == "cpu":
        return cast_triangles_stream_plain(tri_cast_pack, o, d, backface_culling)
    sb, nsb, sb_shift = _warp_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes)
    t_out = torch.empty((R,), dtype=torch.float32, device=dev)
    idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
    _launch(dev,
        "cast_triangles_stream", _ptr(o), _ptr(d), R, _ptr(tri_cast_pack), nb, B,
        _ptr(tri_aabb), _ptr(tri_saabb), _ptr(sb), nsb, sb_shift, rays_per_warp(R),
        int(bool(backface_culling)), _ptr(t_out), _ptr(idx_out),
    )
    return t_out, idx_out


# ---------------------------------------------------------------------------
# occlude_triangles_stream  (TPU: pallas_kernels.py::_occl_stream_kernel, line
# 604) and occlude_triangles  (TPU: pallas_kernels.py::_occlude_kernel, line 964)
# ---------------------------------------------------------------------------

_httr_cache: dict = {}


def _block_httr(block_has_trans, nb, device):
    """The per-block any-transmissive table (nb,) f32 on the device, all
    ones for an empty tuple (JAX intersect.py:485-487); cached per scene: a
    scene past `stream_triangles` has thousands of blocks, and building the
    table per call would cost a host-to-device copy each time."""
    key = (tuple(block_has_trans), nb, str(device))
    with _lock:
        if key not in _httr_cache:
            flags = [float(bool(f)) for f in block_has_trans] or [1.0] * nb
            if len(flags) != nb:
                raise ValueError(f"block_has_trans has {len(flags)} entries for {nb} blocks")
            _httr_cache[key] = torch.tensor(flags, dtype=torch.float32, device=device)
        return _httr_cache[key]


def _occlude_packs_plain(packs, o, d, max_distance, backface_culling):
    R = o.shape[0]
    zero = (torch.zeros((R,), dtype=o.dtype, device=o.device),
            torch.zeros((R,), dtype=torch.bool, device=o.device),
            torch.zeros((R, 3), dtype=o.dtype, device=o.device))
    return _add_pack_occlusion(zero, packs, o, d, max_distance, backface_culling)


def occlude_triangles_stream_plain(tri_cast_pack, o, d, max_distance,
                                   backface_culling=False):
    """Plain twin of the streamed occlusion kernel: one `_pack_occlusion`
    (a block of the JAX `_tri_occlusion_xla`) per Morton block of
    `tri_cast_pack` in order. No gate, no per-block Fresnel skip and no
    early exit: it scans everything, so its sums are also defined for
    occluded rays."""
    return _occlude_packs_plain(tri_cast_pack, o, d, max_distance, backface_culling)


def occlude_triangles_plain(trb_pack, tri_cast_pack, o, d, max_distance,
                            backface_culling=False):
    """Plain twin of the resident occlusion kernel: the big-primitive pack
    first (`_bigtri_occlusion_xla`), then every Morton block in order."""
    return _occlude_packs_plain([trb_pack, *tri_cast_pack], o, d, max_distance,
                                backface_culling)


def _occlusion_outputs(R, dev):
    return (torch.empty((R,), dtype=torch.float32, device=dev),
            torch.empty((R,), dtype=torch.bool, device=dev),
            torch.empty((R, 3), dtype=torch.float32, device=dev))


def occlude_triangles_stream(tri_cast_pack, tri_aabb, tri_saabb, o, d, max_distance, *,
                             sb_sizes, backface_culling=False, block_has_trans=()):
    """Shadow sums of R rays over the Morton blocks of `tri_cast_pack`, for
    scenes past `stream_triangles`, the port's
    `pallas_occlude_triangles_stream`: (opacity_decrement_sum (R,) f32,
    any_opaque (R,) bool, filter_sub (R,3) f32) over the hits with
    t <= max_distance. `block_has_trans`: the scene's per-block
    any-transmissive flags (empty: every block runs the shadow Fresnel);
    `tri_saabb`, `sb_sizes`: the superboxes and their partition of the
    blocks, as `occlude_triangles` takes them. The caller folds in spheres
    and big primitives.

    `any_opaque` is exact. The two sums are specified where `any_opaque` is
    False: the kernel stops a ray's scan at its first opaque hit, the twin
    scans on, and no caller reads the sums of an occluded ray."""
    R, dev = _check_rays("occlude_triangles_stream", o, d, max_distance)
    nb, B = _check_block_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes, dev)
    if dev.type == "cpu":
        return occlude_triangles_stream_plain(tri_cast_pack, o, d, max_distance,
                                              backface_culling)
    sb, nsb, sb_shift = _warp_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes)
    httr = _block_httr(block_has_trans, nb, dev)
    dec, opq, fsub = _occlusion_outputs(R, dev)
    _launch(dev,
        "occlude_triangles_stream", _ptr(o), _ptr(d), _ptr(max_distance), R,
        _ptr(tri_cast_pack), nb, B, _ptr(tri_aabb), _ptr(tri_saabb), _ptr(sb), nsb,
        sb_shift, rays_per_warp(R), _ptr(httr), int(bool(backface_culling)), _ptr(dec),
        _ptr(opq), _ptr(fsub),
    )
    return dec, opq, fsub


def occlude_triangles(trb_pack, tri_cast_pack, tri_aabb, tri_saabb, o, d, max_distance,
                      *, backface_culling=False, bigtri_trans=True, block_has_trans=(),
                      sb_sizes=()):
    """Shadow sums of R rays over the big-primitive pack and the Morton
    blocks of a resident scene, the port's `pallas_occlude_triangles`:
    returns what `occlude_triangles_stream` returns, under the same
    contract for occluded rays. `bigtri_trans`: whether any big primitive
    is transmissive; `sb_sizes`: the superblock partition under
    `tri_saabb` (empty: a superblock per block). The caller folds in the
    spheres."""
    R, dev = _check_rays("occlude_triangles", o, d, max_distance)
    P = trb_pack.shape[0]
    _check(trb_pack, "trb_pack", torch.float32, (P, 32), dev)
    sb_sizes = tuple(sb_sizes) or (1,) * tri_cast_pack.shape[0]
    nb, B = _check_block_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes, dev)
    if dev.type == "cpu":
        return occlude_triangles_plain(trb_pack, tri_cast_pack, o, d, max_distance,
                                       backface_culling)
    _check_big_rows(trb_pack)
    sb, nsb, sb_shift = _warp_tables(tri_cast_pack, tri_aabb, tri_saabb, sb_sizes,
                                     trb_pack=trb_pack)
    httr = _block_httr(block_has_trans, nb, dev)
    dec, opq, fsub = _occlusion_outputs(R, dev)
    _launch(dev,
        "occlude_triangles", _ptr(o), _ptr(d), _ptr(max_distance), R,
        _ptr(trb_pack), P, int(bool(bigtri_trans)), _ptr(tri_cast_pack), nb, B,
        _ptr(tri_aabb), _ptr(tri_saabb), _ptr(sb), nsb, sb_shift, rays_per_warp(R, many=32),
        _ptr(httr), int(bool(backface_culling)), _ptr(dec), _ptr(opq), _ptr(fsub),
    )
    return dec, opq, fsub


# ---------------------------------------------------------------------------
# the shading kernels: shared input checks and the node twin
# ---------------------------------------------------------------------------


def launch_settings() -> tuple:
    """The module settings the wrappers read at each call to choose a
    kernel's form: a CUDA graph of their launches holds for these values
    only."""
    return PACKET_MIN_RAYS, NODE_WARP_MAX_LIVE, LIGHT_LANES_MIN_LIGHTS


_NODE_SCALARS = ("t", "rior", "from_refl", "h_httr", "h_met", "h_ior", "h_opac", "h_boost")


def _check_shading(name, light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
                   point, normal, view, color, shininess, valid, *, n_lights,
                   n_trans_blocks, bigtri_trans_rows):
    """Check the scene tables and the lighting inputs of a shading kernel
    (float32, contiguous, on the points' device). Returns the scene-table
    arguments of the C entry points (ctypes `_SCENE` order)."""
    R = point.shape[0]
    dev = point.device
    f32 = torch.float32
    Lp = light_pack.shape[0]
    S = sph_pack.shape[0]
    P = trb_pack.shape[0]
    nb, B, _ = tri_blk_pack.shape
    _check(light_pack, "light_pack", f32, (Lp, 8), dev)
    _check(sph_pack, "sph_pack", f32, (S, 16), dev)
    _check(trb_pack, "trb_pack", f32, (P, 32), dev)
    _check(tri_blk_pack, "tri_blk_pack", f32, (nb, B, 32), dev)
    _check(tri_blk_aabb, "tri_blk_aabb", f32, (nb, 8), dev)
    for k, v in dict(point=point, normal=normal, view=view, color=color).items():
        _check(v, k, f32, (R, 3), dev)
    _check(shininess, "shininess", f32, (R,), dev)
    _check(valid, "valid", f32, (R,), dev)
    if not 0 < n_lights <= Lp:
        raise ValueError(f"n_lights={n_lights} outside (0, {Lp}]")
    if not (0 <= bigtri_trans_rows <= P and 0 <= n_trans_blocks <= nb):
        raise ValueError("bigtri_trans_rows / n_trans_blocks outside the packs")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return (_ptr(light_pack), int(n_lights), _ptr(sph_pack), S, _ptr(trb_pack), P,
            int(bigtri_trans_rows), _ptr(tri_blk_pack), _ptr(tri_blk_aabb), nb, B,
            int(n_trans_blocks))


def _check_node(w, budget, node, R, dev):
    """Check a node kernel's per-ray state: w (R,3) f32, budget (R,) int32,
    and the (R,) f32 fields of `_NODE_SCALARS` (in that order)."""
    _check(w, "w", torch.float32, (R, 3), dev)
    _check(budget, "budget", torch.int32, (R,), dev)
    for k, v in zip(_NODE_SCALARS, node):
        _check(v, k, torch.float32, (R,), dev)


def _node_gate(sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb):
    """The node kernels' arguments of the block gate of their warp form:
    superboxes, superblock starts, count and shift (`_warp_tables`).
    tri_blk_pack has no superboxes of its own (the scene's follow the cast
    order), so each block is a superblock of its own."""
    _check_big_rows(trb_pack)
    nb = tri_blk_pack.shape[0]
    sb, nsb, sb_shift = _warp_tables(tri_blk_pack, tri_blk_aabb, tri_blk_aabb, (1,) * nb,
                                     trb_pack=trb_pack, sph_pack=sph_pack)
    return _ptr(tri_blk_aabb), _ptr(sb), nsb, sb_shift


def _node_consts(eps_dist, backface_culling, reflections, refractions, refl_max,
                 refr_max, weight_cutoff, air):
    return (float(eps_dist), int(bool(backface_culling)), int(bool(reflections)),
            int(bool(refractions)), int(refl_max), int(refr_max), float(weight_cutoff),
            float(air))


def _node_plain(light_pack, sph_pack, trb_pack, tri_blk_pack, point, normal, view,
                color, shininess, valid, t, w, rior, budget, from_refl, h_httr, h_met,
                h_ior, h_opac, h_boost, *, n_lights, eps_dist, backface_culling,
                reflections, refractions, refl_max, refr_max, weight_cutoff, air):
    """The node kernels' plain body: the lighting of the plain path
    (ops/shading.py::light_sums + ambient) and the child math of
    `_eval_node` (ops/trace.py::_node_children). Returns (contrib,
    refl_push, refr_push); a push is None for a disabled child type."""
    hval = valid != 0.0
    direct, spec = light_sums(
        light_pack, n_lights, sph_pack, trb_pack, tri_blk_pack, point, normal,
        view, color, shininess, hval, eps_dist, backface_culling,
    )
    return _node_children(
        point, normal, color, h_met, h_httr != 0.0, h_ior, h_opac, h_boost, t, hval,
        ambient(color, hval) + direct, spec, view, rior, w, budget, from_refl != 0.0,
        eps_dist, reflections=reflections, refractions=refractions, refl_max=refl_max,
        refr_max=refr_max, weight_cutoff=weight_cutoff, air=air,
    )


# ---------------------------------------------------------------------------
# light_shade  (TPU: pallas_kernels.py::_light_shade_kernel, line 1834)
# ---------------------------------------------------------------------------


def light_shade_plain(light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
                      point, normal, view, color, shininess, valid, *, n_lights,
                      eps_dist, n_trans_blocks=0, backface_culling=False,
                      bigtri_trans_rows=8):
    """Plain twin of the light kernel: ops/shading.py::light_sums (the
    plain lighting path, no ambient). `tri_blk_aabb`, `n_trans_blocks` and
    `bigtri_trans_rows` only let the kernel skip work that cannot change
    the result; the twin does that work."""
    del tri_blk_aabb, n_trans_blocks, bigtri_trans_rows
    return light_sums(
        light_pack, n_lights, sph_pack, trb_pack, tri_blk_pack, point, normal, view,
        color, shininess, valid != 0.0, eps_dist, backface_culling,
    )


def light_shade(light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
                point, normal, view, color, shininess, valid, *, n_lights, eps_dist,
                n_trans_blocks=0, backface_culling=False, bigtri_trans_rows=8):
    """Direct + specular lighting of R rays over the first n_lights point
    lights, shadows included and ambient left out: the port's
    `pallas_light_shade`. Per-ray inputs: point, normal, view (= the ray
    direction), color (R,3) f32; shininess, valid (1.0/0.0) (R,) f32.
    Returns (direct (R,3), spec (R,3)). On the card the work is split by
    (ray, light) (csrc/light_shade.cu)."""
    scene = _check_shading(
        "light_shade", light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
        point, normal, view, color, shininess, valid, n_lights=n_lights,
        n_trans_blocks=n_trans_blocks, bigtri_trans_rows=bigtri_trans_rows,
    )
    if point.device.type == "cpu":
        return light_shade_plain(
            light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb, point, normal,
            view, color, shininess, valid, n_lights=n_lights, eps_dist=eps_dist,
            backface_culling=backface_culling,
        )
    R = point.shape[0]
    direct = torch.empty((R, 3), dtype=torch.float32, device=point.device)
    spec = torch.empty_like(direct)
    _launch(point.device,
        "light_shade", *scene, _ptr(point), _ptr(normal), _ptr(view), _ptr(color),
        _ptr(shininess), _ptr(valid), R, float(eps_dist), int(bool(backface_culling)),
        _ptr(direct), _ptr(spec),
    )
    return direct, spec


# ---------------------------------------------------------------------------
# shade_eval  (TPU: pallas_kernels.py::_shade_eval_kernel, packed_rows=False,
# line 1858)
# ---------------------------------------------------------------------------

# The most live rays (valid != 0) for which shade_eval takes a warp per ray;
# from there on, a ray per lane. The kernel reads the count on the device.
# Measured on an H100 (PERF.md, section 6): at 4,636 live rays of a stack
# wavefront a warp per ray took 0.076 ms and a ray per lane 0.246, at 30,653
# 0.364 and 0.283; the two lines cross near 22,000.
NODE_WARP_MAX_LIVE = 22528


def shade_eval_plain(
    light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
    point, normal, view, color, shininess, valid,
    t, w, rior, budget, from_refl, h_httr, h_met, h_ior, h_opac, h_boost,
    *, n_lights, eps_dist, n_trans_blocks=0, backface_culling=False,
    bigtri_trans_rows=8, reflections=True, refractions=True, refl_max=5,
    refr_max=10, weight_cutoff=0.0, air=1.000293,
):
    """Plain twin of the per-field node kernel (`_node_plain`), in the
    kernel's output form; a disabled child type gives zeros, False masks
    and (refraction) ior 1."""
    del tri_blk_aabb, n_trans_blocks, bigtri_trans_rows
    R = point.shape[0]
    contrib, refl, refr = _node_plain(
        light_pack, sph_pack, trb_pack, tri_blk_pack, point, normal, view, color,
        shininess, valid, t, w, rior, budget, from_refl, h_httr, h_met, h_ior, h_opac,
        h_boost, n_lights=n_lights, eps_dist=eps_dist, backface_culling=backface_culling,
        reflections=reflections, refractions=refractions, refl_max=refl_max,
        refr_max=refr_max, weight_cutoff=weight_cutoff, air=air,
    )

    def fields(push, keys):
        if push is None:
            z3 = torch.zeros((R, 3), dtype=torch.float32, device=point.device)
            push = dict(o=z3, d=z3, w=z3, budget=torch.zeros_like(budget),
                        ior=torch.ones_like(rior),
                        mask=torch.zeros((R,), dtype=torch.bool, device=point.device))
        return {k: push[k] for k in keys}

    return (contrib, fields(refl, ("o", "d", "w", "budget", "mask")),
            fields(refr, ("o", "d", "w", "budget", "ior", "mask")))


def shade_eval(
    light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
    point, normal, view, color, shininess, valid,
    t, w, rior, budget, from_refl, h_httr, h_met, h_ior, h_opac, h_boost,
    *, n_lights, eps_dist, n_trans_blocks=0, backface_culling=False,
    bigtri_trans_rows=8, reflections=True, refractions=True, refl_max=5,
    refr_max=10, weight_cutoff=0.0, air=1.000293,
):
    """Fused lighting + node evaluation for R rays with per-field outputs,
    the port's `pallas_shade_eval`. Per-ray inputs as `shade_eval_rows`
    without `pix`. Returns (contrib (R,3), refl {o, d, w (R,3); budget (R,)
    int32; mask (R,) bool}, refr {o, d, w; budget; ior (R,) f32; mask}).
    On the card only the rays with valid != 0 are lit, a warp per ray up to
    NODE_WARP_MAX_LIVE of them and a ray per lane beyond (the kernel counts
    them itself); the bits are shade_eval_rows' in both forms."""
    node = (t, rior, from_refl, h_httr, h_met, h_ior, h_opac, h_boost)
    scene = _check_shading(
        "shade_eval", light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
        point, normal, view, color, shininess, valid, n_lights=n_lights,
        n_trans_blocks=n_trans_blocks, bigtri_trans_rows=bigtri_trans_rows,
    )
    R = point.shape[0]
    dev = point.device
    _check_node(w, budget, node, R, dev)
    consts = dict(n_lights=n_lights, eps_dist=eps_dist, backface_culling=backface_culling,
                  reflections=reflections, refractions=refractions, refl_max=refl_max,
                  refr_max=refr_max, weight_cutoff=weight_cutoff, air=air)
    if dev.type == "cpu":
        return shade_eval_plain(
            light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb, point, normal,
            view, color, shininess, valid, t, w, rior, budget, from_refl, h_httr, h_met,
            h_ior, h_opac, h_boost, **consts,
        )
    gate = _node_gate(sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb)
    f32 = torch.float32

    def vec3():
        return torch.empty((R, 3), dtype=f32, device=dev)

    contrib = vec3()
    refl = dict(o=vec3(), d=vec3(), w=vec3(),
                budget=torch.empty((R,), dtype=torch.int32, device=dev),
                mask=torch.empty((R,), dtype=torch.bool, device=dev))
    refr = dict(o=vec3(), d=vec3(), w=vec3(),
                budget=torch.empty((R,), dtype=torch.int32, device=dev),
                ior=torch.empty((R,), dtype=f32, device=dev),
                mask=torch.empty((R,), dtype=torch.bool, device=dev))
    # the live list, its segments' counts (then their offsets) and the live
    # count (csrc/shade_eval.cu)
    scratch = torch.empty((R + -(-R // 128) + 1,), dtype=torch.int32, device=dev)
    _launch(dev,
        "shade_eval", *scene, *gate, int(NODE_WARP_MAX_LIVE),
        _ptr(point), _ptr(normal), _ptr(view), _ptr(color), _ptr(shininess),
        _ptr(valid), _ptr(t), _ptr(w), _ptr(rior), _ptr(budget), _ptr(from_refl),
        _ptr(h_httr), _ptr(h_met), _ptr(h_ior), _ptr(h_opac), _ptr(h_boost), R,
        *_node_consts(eps_dist, backface_culling, reflections, refractions, refl_max,
                      refr_max, weight_cutoff, air),
        _ptr(scratch), _ptr(contrib), *[_ptr(refl[k]) for k in ("o", "d", "w", "budget", "mask")],
        *[_ptr(refr[k]) for k in ("o", "d", "w", "budget", "ior", "mask")],
    )
    return contrib, refl, refr


# ---------------------------------------------------------------------------
# shade_eval_rows  (TPU: pallas_kernels.py::_shade_eval_kernel, packed_rows=True,
# line 1858)
# ---------------------------------------------------------------------------


def shade_eval_rows_plain(
    light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
    point, normal, view, color, shininess, valid,
    t, w, rior, budget, from_refl, h_httr, h_met, h_ior, h_opac, h_boost, pix,
    *, n_lights, eps_dist, n_trans_blocks=0, backface_culling=False,
    bigtri_trans_rows=8, reflections=True, refractions=True, refl_max=5,
    refr_max=10, weight_cutoff=0.0, air=1.000293,
):
    """Plain twin of the packed-row node kernel: `_node_plain`, then
    `_pack_entry` for each child."""
    del tri_blk_aabb, n_trans_blocks, bigtri_trans_rows
    R = point.shape[0]
    contrib, refl, refr = _node_plain(
        light_pack, sph_pack, trb_pack, tri_blk_pack, point, normal, view, color,
        shininess, valid, t, w, rior, budget, from_refl, h_httr, h_met, h_ior, h_opac,
        h_boost, n_lights=n_lights, eps_dist=eps_dist, backface_culling=backface_culling,
        reflections=reflections, refractions=refractions, refl_max=refl_max,
        refr_max=refr_max, weight_cutoff=weight_cutoff, air=air,
    )

    def rows(push):
        if push is None:
            return (torch.zeros((R, POOL_COLS), dtype=torch.float32, device=point.device),
                    torch.zeros((R,), dtype=torch.bool, device=point.device))
        return _pack_entry(push, pix), push["mask"]

    rfl_rows, rfl_m = rows(refl)
    rfr_rows, rfr_m = rows(refr)
    return contrib, rfl_rows, rfl_m, rfr_rows, rfr_m


def shade_eval_rows(
    light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
    point, normal, view, color, shininess, valid,
    t, w, rior, budget, from_refl, h_httr, h_met, h_ior, h_opac, h_boost, pix,
    *, n_lights, eps_dist, n_trans_blocks=0, backface_culling=False,
    bigtri_trans_rows=8, reflections=True, refractions=True, refl_max=5,
    refr_max=10, weight_cutoff=0.0, air=1.000293,
):
    """Fused lighting + node evaluation for R rays, the port's
    `pallas_shade_eval_rows`. Per-ray inputs: point, normal, view (= the ray
    direction), color, w (R,3) f32; shininess, valid (1.0/0.0), t, rior,
    from_refl, h_httr, h_met, h_ior, h_opac, h_boost (R,) f32; budget, pix
    (R,) int32. Returns (contrib (R,3), rfl_rows (R,16), rfl_mask (R,) bool,
    rfr_rows (R,16), rfr_mask (R,) bool); rows/masks of a disabled child
    type are zeros/False."""
    node = (t, rior, from_refl, h_httr, h_met, h_ior, h_opac, h_boost)
    scene = _check_shading(
        "shade_eval_rows", light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
        point, normal, view, color, shininess, valid, n_lights=n_lights,
        n_trans_blocks=n_trans_blocks, bigtri_trans_rows=bigtri_trans_rows,
    )
    R = point.shape[0]
    dev = point.device
    _check_node(w, budget, node, R, dev)
    _check(pix, "pix", torch.int32, (R,), dev)
    if dev.type == "cpu":
        return shade_eval_rows_plain(
            light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb,
            point, normal, view, color, shininess, valid, t, w, rior, budget,
            from_refl, h_httr, h_met, h_ior, h_opac, h_boost, pix,
            n_lights=n_lights, eps_dist=eps_dist, backface_culling=backface_culling,
            reflections=reflections, refractions=refractions, refl_max=refl_max,
            refr_max=refr_max, weight_cutoff=weight_cutoff, air=air,
        )
    gate = _node_gate(sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb)
    f32 = torch.float32
    contrib = torch.empty((R, 3), dtype=f32, device=dev)
    rfl_rows = torch.empty((R, POOL_COLS), dtype=f32, device=dev)
    rfr_rows = torch.empty((R, POOL_COLS), dtype=f32, device=dev)
    rfl_m = torch.empty((R,), dtype=torch.bool, device=dev)
    rfr_m = torch.empty((R,), dtype=torch.bool, device=dev)
    form = node_form(R, n_lights)
    _launch(dev,
        "shade_eval_rows", *scene, *gate, form,
        _ptr(point), _ptr(normal), _ptr(view), _ptr(color), _ptr(shininess),
        _ptr(valid), _ptr(t), _ptr(w), _ptr(rior), _ptr(budget), _ptr(from_refl),
        _ptr(h_httr), _ptr(h_met), _ptr(h_ior), _ptr(h_opac), _ptr(h_boost),
        _ptr(pix), R,
        *_node_consts(eps_dist, backface_culling, reflections, refractions, refl_max,
                      refr_max, weight_cutoff, air),
        _ptr(contrib), _ptr(rfl_rows), _ptr(rfl_m), _ptr(rfr_rows), _ptr(rfr_m),
    )
    if form == LIGHT_LANES:
        _count(LIGHT_LANES_LAUNCHES)
    return contrib, rfl_rows, rfl_m, rfr_rows, rfr_m


# ---------------------------------------------------------------------------
# the pool iteration's glue: pool_take, pool_hit, pool_put (no TPU kernel;
# the JAX package leaves these steps of `_run_pool` to XLA)
# ---------------------------------------------------------------------------
#
# ops/trace.py's `_pool_loop` runs a pool iteration on the card as five
# kernels: pool_take, cast_triangles, pool_hit, shade_eval_rows, pool_put.
# Each twin is the iteration's PyTorch glue (`glue_step`) factored out, and
# each kernel gives its twin's bits on every lane, dead and missed lanes
# included.


def pool_take_plain(pool, count, W):
    """Plain twin of the take: `_pool_window`, `_unpack_entry`, `_park`,
    the node kernels' dtypes."""
    lanes = torch.arange(W, dtype=torch.int64, device=pool.device)
    start, active, rows = _pool_window(pool, count, lanes)
    e = _unpack_entry(rows)
    o, d = _park(e["o"], e["d"], active)
    return (o, d, e["w"].contiguous(), e["ior"].contiguous(), e["budget"].contiguous(),
            e["from_refl"].to(torch.float32), e["pix"].to(torch.int32),
            torch.stack([start, count]))


def _check_pool(pool, dev):
    _check(pool, "pool", torch.float32, (pool.shape[0], POOL_COLS), dev)
    if pool.shape[0] < 2 or pool.data_ptr() % 16:
        raise ValueError("pool: needs a dump row and 16-byte aligned rows")


def pool_take(pool, count, *, W):
    """The pool loop's take at width W: the rows [start, start + W) of the
    packed pool (Q + 1, 16), start = max(count - W, 0) (`count`: int64 ()),
    unpacked. Returns (o, d (W, 3) f32, parked where the lane is past count;
    w (W, 3) f32; ior (W,) f32; budget (W,) int32; from_refl (W,) f32;
    pix (W,) int32; take (2,) int64 [start, count])."""
    dev = pool.device
    _check_pool(pool, dev)
    _check(count, "count", torch.int64, (), dev)
    if not 0 < W < pool.shape[0]:
        raise ValueError(f"W={W} outside (0, {pool.shape[0]})")
    if dev.type == "cpu":
        return pool_take_plain(pool, count, W)
    f32 = torch.float32
    o, d, w = (torch.empty((W, 3), dtype=f32, device=dev) for _ in range(3))
    ior, from_refl = torch.empty((W,), dtype=f32, device=dev), torch.empty((W,), dtype=f32,
                                                                           device=dev)
    budget, pix = (torch.empty((W,), dtype=torch.int32, device=dev) for _ in range(2))
    take = torch.empty((2,), dtype=torch.int64, device=dev)
    _launch(dev, "pool_take", _ptr(pool), _ptr(count), W, _ptr(o), _ptr(d), _ptr(w),
            _ptr(ior), _ptr(budget), _ptr(from_refl), _ptr(pix), _ptr(take))
    return o, d, w, ior, budget, from_refl, pix, take


def pool_hit_plain(sph_pack, mat_pack, o, d, tt, tidx, take, backface_culling=False):
    """Plain twin of the hit record: the spheres (`_sphere_nearest_of` over
    the sphere pack's columns), the cast's epilogue (`_hit_record`), the
    active lanes' hits (`_active_hit`) and the node kernels' dtypes
    (`_hit_fields`)."""
    S = sph_pack.shape[0]
    lanes = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    best_t, best_idx = _sphere_nearest_of(sph_pack[:, 0:3], sph_pack[:, 3],
                                          sph_pack[:, 12] != 0.0, sph_pack[:, 8] != 0.0, o, d,
                                          backface_culling)
    hit = _hit_record(mat_pack, S, o, d, best_t, best_idx, tt, tidx, S)
    return _hit_fields(hit, *_active_hit(hit, take[0] + lanes < take[1]))


def pool_hit(sph_pack, mat_pack, o, d, tt, tidx, take, *, backface_culling=False):
    """The pool loop's hit record of W parked rays o, d (W, 3) f32 (`pool_take`)
    after the triangle cast (tt (W,) f32, tidx (W,) int32, `cast_triangles`):
    the nearest sphere of the sphere pack (S, 16), the triangle hit folded
    in at index S + tidx, the packed material row (`mat_pack` (N, 16)), the
    normal, and the lanes below take[1] - take[0] active. Returns the node
    kernels' hit inputs (point, normal, color (W, 3); shininess, valid
    (1.0 / 0.0), t, has_trans (1.0 / 0.0), metallic, ior, opacity, boost
    (W,); all f32), the point parked at 1e9 where there is no active hit."""
    W, dev = _check_rays("pool_hit", o, d)
    f32 = torch.float32
    S = sph_pack.shape[0]
    _check(sph_pack, "sph_pack", f32, (S, 16), dev)
    _check(mat_pack, "mat_pack", f32, (mat_pack.shape[0], 16), dev)
    _check(tt, "tt", f32, (W,), dev)
    _check(tidx, "tidx", torch.int32, (W,), dev)
    _check(take, "take", torch.int64, (2,), dev)
    if not 0 < S <= mat_pack.shape[0]:
        raise ValueError(f"{S} sphere slots for {mat_pack.shape[0]} material rows")
    if dev.type == "cpu":
        return pool_hit_plain(sph_pack, mat_pack, o, d, tt, tidx, take, backface_culling)
    vec = [torch.empty((W, 3), dtype=f32, device=dev) for _ in range(3)]
    scal = [torch.empty((W,), dtype=f32, device=dev) for _ in range(8)]
    _launch(dev, "pool_hit", _ptr(sph_pack), S, _ptr(mat_pack), _ptr(o), _ptr(d), _ptr(tt),
            _ptr(tidx), _ptr(take), W, int(bool(backface_culling)),
            *[_ptr(t) for t in vec + scal])
    return (*vec, *scal)


def _put_children(rfl_rows, rfl_m, rfr_rows, rfr_m, reflections, refractions):
    """The enabled children's (rows, mask) in the pool-append order [refr,
    refl]."""
    return ([(rfr_rows, rfr_m)] if refractions else []) + (
        [(rfl_rows, rfl_m)] if reflections else [])


def pool_put_plain(pool, count, dropped, stage_pix, stage_contrib, take, pix, contrib,
                   rfl_rows, rfl_m, rfr_rows, rfr_m, *, slot, R, Q_cap, reflections=True,
                   refractions=True):
    """Plain twin of the put: `_pool_put` on the take's window, the children
    concatenated in the pool-append order; count and dropped rewritten."""
    W = contrib.shape[0]
    lanes = torch.arange(W, dtype=torch.int64, device=pool.device)
    children = _put_children(rfl_rows, rfl_m, rfr_rows, rfr_m, reflections, refractions)
    start, n = take[0], take[1]
    new_count, new_dropped, _ = _pool_put(
        pool, stage_pix, stage_contrib, slot, R, Q_cap, start, dropped, start + lanes < n,
        pix.to(torch.int64), contrib, torch.cat([r for r, _ in children]),
        torch.cat([m for _, m in children]), lanes)
    count.copy_(new_count)
    dropped.copy_(new_dropped)


def pool_put(pool, count, dropped, stage_pix, stage_contrib, take, pix, contrib, rfl_rows,
             rfl_m, rfr_rows, rfr_m, *, slot, R, Q_cap, reflections=True, refractions=True):
    """The pool loop's put for iteration `slot` of a chunk, IN PLACE: lane l
    of the take's window (take: [start, count] of `pool_take`) stages its
    pixel (pix (W,) int32) and contribution (contrib (W, 3) f32) at row
    slot * W + l of stage_pix (int64) and stage_contrib, or where it is past
    count its dump row R + slot * W + l and 0; the enabled children's rows
    (W, 16) whose masks (W,) bool are set on a live lane are appended to the
    pool (Q + 1, 16) at min(start, Q_cap - 2W) in the pool-append order
    [refr, refl] (the last rejected row to the dump row Q); count (int64 ())
    becomes the new top and dropped (int64 ()) grows by the rows the cap
    cut. A disabled child's rows and mask are not read."""
    dev = pool.device
    W = contrib.shape[0]
    f32 = torch.float32
    _check_pool(pool, dev)
    _check(count, "count", torch.int64, (), dev)
    _check(dropped, "dropped", torch.int64, (), dev)
    _check(take, "take", torch.int64, (2,), dev)
    _check(pix, "pix", torch.int32, (W,), dev)
    _check(contrib, "contrib", f32, (W, 3), dev)
    n_stage = stage_pix.shape[0]
    _check(stage_pix, "stage_pix", torch.int64, (n_stage,), dev)
    _check(stage_contrib, "stage_contrib", f32, (n_stage, 3), dev)
    children = _put_children(rfl_rows, rfl_m, rfr_rows, rfr_m, reflections, refractions)
    for rows, m in children:
        _check(rows, "rows", f32, (W, POOL_COLS), dev)
        _check(m, "mask", torch.bool, (W,), dev)
        if rows.data_ptr() % 16:
            raise ValueError("rows: not aligned to 16 bytes")
    Q = pool.shape[0] - 1
    if not (children and W > 0 and 0 <= slot and (slot + 1) * W <= n_stage
            and 2 * W <= Q_cap <= Q):
        raise ValueError(f"pool_put: children {len(children)}, W={W}, slot={slot} of "
                         f"{n_stage // max(W, 1)}, Q_cap={Q_cap}, Q={Q}")
    if dev.type == "cpu":
        return pool_put_plain(pool, count, dropped, stage_pix, stage_contrib, take, pix,
                              contrib, rfl_rows, rfl_m, rfr_rows, rfr_m, slot=slot, R=R,
                              Q_cap=Q_cap, reflections=reflections, refractions=refractions)
    (rows_a, m_a), (rows_b, m_b) = children[0], children[-1]
    _launch(dev, "pool_put", _ptr(pool), Q, int(Q_cap), _ptr(count), _ptr(dropped),
            _ptr(stage_pix), _ptr(stage_contrib), _ptr(take), _ptr(pix), _ptr(contrib),
            _ptr(rows_a), _ptr(m_a), _ptr(rows_b), _ptr(m_b), len(children), W, int(slot),
            int(R))


# the module's own kernel wrappers, by name (ops/trace.py's chunk graphs)
_OWN = {name: globals()[name] for name in KERNEL_SOURCES}


def swapped_wrappers() -> dict:
    """{name: wrapper} of the kernel wrappers that are not the module's own.
    One swapped in (a hook that watches the calls, a stand-in) is Python a
    CUDA graph of its launches would not run: ops/trace.py's chunk graphs
    call it eagerly between graphs."""
    g = globals()
    return {name: g[name] for name, fn in _OWN.items() if g[name] is not fn}
