"""The port's hand-written CUDA kernels, their wrappers and plain twins.

Four kernels, each replacing one Pallas kernel of the JAX package
(ops/pallas_kernels.py):

* `cast_triangles`  <- `_cast_kernel` / `pallas_cast_triangles` (every path)
* `shade_eval_rows` <- `_shade_eval_kernel(packed_rows=True)` /
  `pallas_shade_eval_rows` (the packed-row pool path)
* `shade_eval`      <- `_shade_eval_kernel(packed_rows=False)` /
  `pallas_shade_eval` (the per-ray stack path, `packed_stage=False`)
* `light_shade`     <- `_light_shade_kernel` / `pallas_light_shade`
  (configs without reflections or refractions)

Sources are `csrc/*.cu` (CUDA C++ for sm_90a with a plain C interface); the
three shading kernels share the device code of `rt_light.cuh` and
`rt_node.cuh`.
They are built with nvcc on first use into `build/torch_kernels/` at the
repository root (keyed by a hash of the sources and flags; one nvcc per
source, all started together) and loaded with ctypes. Each kernel launches
on `torch.cuda.current_stream()` and its C entry point returns
`cudaGetLastError()`; the wrapper raises if that is not 0.

The device of the input tensors picks the implementation: a CUDA tensor
goes to the kernel (or the call raises); a CPU tensor goes to the plain
PyTorch twin (`*_plain`), which the CPU tests hold against the JAX package.
`LAUNCHES` counts kernel launches (twin calls are not counted).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .intersect import BIG_IDX, _homogeneous, _pack_nearest
from .shading import ambient, light_sums
from .trace import POOL_COLS, _node_children, _pack_entry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_PKG))), "build", "torch_kernels"
)
KERNEL_SOURCES = {
    "cast_triangles": "cast_triangles.cu",
    "shade_eval_rows": "shade_eval_rows.cu",
    "shade_eval": "shade_eval.cu",
    "light_shade": "light_shade.cu",
}
COMMON_HEADERS = ("rt_common.cuh", "rt_light.cuh", "rt_node.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {name: 0 for name in KERNEL_SOURCES}

_lock = threading.Lock()
_libs: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# scene tables of the shading kernels: lights, n_lights, sph, S, trb, P,
# trans_rows, blk, blk_aabb, nb, B, n_trans_blocks
_SCENE = [_P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I]
_ARGTYPES = {
    "cast_triangles": ("rt_cast_triangles", [
        _P, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P]),
    "shade_eval_rows": ("rt_shade_eval_rows", [
        *_SCENE, *([_P] * 17), _I,  # per-ray fields, R
        _F, _I, _I, _I, _I, _I, _F, _F,  # node constants
        *([_P] * 6)]),  # 5 outputs, stream
    "shade_eval": ("rt_shade_eval", [
        *_SCENE, *([_P] * 16), _I,  # per-ray fields, R
        _F, _I, _I, _I, _I, _I, _F, _F,  # node constants
        *([_P] * 13)]),  # 12 outputs, stream
    "light_shade": ("rt_light_shade", [
        *_SCENE, *([_P] * 6), _I, _F, _I, _P, _P, _P]),
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


def _launch(name, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


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
    if key not in _sb_cache:
        sizes = list(sb_sizes) or [1] * nb
        if sum(sizes) != nb:
            raise ValueError(f"superblock sizes {sizes} do not cover {nb} blocks")
        starts = [0]
        for n in sizes:
            starts.append(starts[-1] + n)
        _sb_cache[key] = torch.tensor(starts, dtype=torch.int32, device=device)
    return _sb_cache[key]


def cast_triangles_plain(trb_pack, tri_cast_pack, o, d, backface_culling=False):
    """Plain twin of the cast kernel: the JAX plain path's big-primitive and
    Morton-block nearest hits (`_bigtri_nearest_xla`, `_tri_nearest_xla`),
    over the same packs and in the kernel's index space (big primitive
    p -> p, Morton slot (b, c) -> P + b*B + c; miss: +inf, 2^31-1). No AABB
    gate: the kernel's widened gate never changes the result."""
    P = trb_pack.shape[0]
    nb, B, _ = tri_cast_pack.shape
    o4 = _homogeneous(o)
    best_t, bidx = _pack_nearest(trb_pack, o4, d, backface_culling)
    best_idx = torch.where(torch.isfinite(best_t), bidx, torch.full_like(bidx, BIG_IDX))
    for b in range(nb):
        tmin, targ = _pack_nearest(tri_cast_pack[b], o4, d, backface_culling)
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_idx = torch.where(closer, P + b * B + targ, best_idx)
    return best_t, best_idx.to(torch.int32)


def cast_triangles(trb_pack, tri_cast_pack, tri_aabb, tri_saabb, o, d, *,
                   backface_culling=False, sb_sizes=()):
    """Nearest triangle hit of R rays: (t (R,) f32, idx (R,) int32) in the
    TPU kernel's local index space (see `cast_triangles_plain`)."""
    R = o.shape[0]
    dev = o.device
    P = trb_pack.shape[0]
    nb, B, _ = tri_cast_pack.shape
    f32 = torch.float32
    _check(o, "o", f32, (R, 3), dev)
    _check(d, "d", f32, (R, 3), dev)
    _check(trb_pack, "trb_pack", f32, (P, 32), dev)
    _check(tri_cast_pack, "tri_cast_pack", f32, (nb, B, 32), dev)
    _check(tri_aabb, "tri_aabb", f32, (nb, 8), dev)
    nsb = len(sb_sizes) or nb
    _check(tri_saabb, "tri_saabb", f32, (len(sb_sizes) or tri_saabb.shape[0], 8), dev)
    if dev.type == "cpu":
        return cast_triangles_plain(trb_pack, tri_cast_pack, o, d, backface_culling)
    if dev.type != "cuda":
        raise ValueError(f"cast_triangles: unsupported device {dev}")
    o_soa = o.t().contiguous()  # (3, R): coalesced per-ray loads
    d_soa = d.t().contiguous()
    t_out = torch.empty((R,), dtype=f32, device=dev)
    idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
    sb = _sb_start(sb_sizes, nb, dev)
    _launch(
        "cast_triangles", _ptr(o_soa), _ptr(d_soa), R, _ptr(trb_pack), P,
        _ptr(tri_cast_pack), nb, B, _ptr(tri_aabb), _ptr(tri_saabb), _ptr(sb), nsb,
        int(bool(backface_culling)), _ptr(t_out), _ptr(idx_out),
    )
    return t_out, idx_out


# ---------------------------------------------------------------------------
# the shading kernels: shared input checks and the node twin
# ---------------------------------------------------------------------------

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
    Returns (direct (R,3), spec (R,3))."""
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
    _launch(
        "light_shade", *scene, _ptr(point), _ptr(normal), _ptr(view), _ptr(color),
        _ptr(shininess), _ptr(valid), R, float(eps_dist), int(bool(backface_culling)),
        _ptr(direct), _ptr(spec),
    )
    return direct, spec


# ---------------------------------------------------------------------------
# shade_eval  (TPU: pallas_kernels.py::_shade_eval_kernel, packed_rows=False,
# line 1858)
# ---------------------------------------------------------------------------


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
    int32; mask (R,) bool}, refr {o, d, w; budget; ior (R,) f32; mask})."""
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
    _launch(
        "shade_eval", *scene,
        _ptr(point), _ptr(normal), _ptr(view), _ptr(color), _ptr(shininess),
        _ptr(valid), _ptr(t), _ptr(w), _ptr(rior), _ptr(budget), _ptr(from_refl),
        _ptr(h_httr), _ptr(h_met), _ptr(h_ior), _ptr(h_opac), _ptr(h_boost), R,
        *_node_consts(eps_dist, backface_culling, reflections, refractions, refl_max,
                      refr_max, weight_cutoff, air),
        _ptr(contrib), *[_ptr(refl[k]) for k in ("o", "d", "w", "budget", "mask")],
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
    f32 = torch.float32
    contrib = torch.empty((R, 3), dtype=f32, device=dev)
    rfl_rows = torch.empty((R, POOL_COLS), dtype=f32, device=dev)
    rfr_rows = torch.empty((R, POOL_COLS), dtype=f32, device=dev)
    rfl_m = torch.empty((R,), dtype=torch.bool, device=dev)
    rfr_m = torch.empty((R,), dtype=torch.bool, device=dev)
    _launch(
        "shade_eval_rows", *scene,
        _ptr(point), _ptr(normal), _ptr(view), _ptr(color), _ptr(shininess),
        _ptr(valid), _ptr(t), _ptr(w), _ptr(rior), _ptr(budget), _ptr(from_refl),
        _ptr(h_httr), _ptr(h_met), _ptr(h_ior), _ptr(h_opac), _ptr(h_boost),
        _ptr(pix), R,
        *_node_consts(eps_dist, backface_culling, reflections, refractions, refl_max,
                      refr_max, weight_cutoff, air),
        _ptr(contrib), _ptr(rfl_rows), _ptr(rfl_m), _ptr(rfr_rows), _ptr(rfr_m),
    )
    return contrib, rfl_rows, rfl_m, rfr_rows, rfr_m
