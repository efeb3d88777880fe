"""Wavefront Whitted tracing: the reference's recursion tree as a ray pool
or a per-ray stack.

The port's counterpart of the JAX package's `ops/trace.py`. The reference
recursively branches into a reflection subtree and a refraction subtree per
hit (ref raytracer_renderer.rs:147-264, 279-524, 526-729). Here every
pending ray carries its accumulated *weight* (the product of Fresnel
reflectances / transmittances / boosts along its path), so contributions are
linear and can be summed into the framebuffer in any order. Three paths, as
in the JAX package:

* the pool path (tiles of at least kernel_ray_tile * compaction_ratio rays
  with children): a dense LIFO pool of packed (16,) f32 rows, W rays
  serviced per iteration (`_run_pool`); the node kernel writes packed rows
  (`shade_eval_rows`), or per-field children with `packed_stage=False`
  (`shade_eval`, then `_pack_entry`);
* the stack path (smaller tiles, or compaction_ratio 1): one pop per ray
  per iteration from a per-ray stack (`_run_stack`), nodes through
  `shade_eval`;
* configs without reflections or refractions: the primary node alone, lit
  through `light_shade` (`calculate_lighting`).

A streamed scene (`scene.streaming`, past `cfg.stream_triangles`) takes the
same three paths with the plain node: the cast through
`cast_triangles_stream`, the lighting through `calculate_lighting`'s light
loop over `occlude_rays` (`occlude_triangles_stream`), the children in plain
PyTorch (`_node_children`); the pool then appends per-field children
(`_pack_entry`), never the packed rows of `shade_eval_rows`.

Depth-budget semantics copied exactly (they shape the image):
* budget -1 encodes the reference's `None` (top level); the first reflection
  child then gets RAYTRACE_REFLECTION_MAX_DEPTH, the first refraction child
  RAYTRACE_REFRACTION_MAX_DEPTH / depth_factor  (raytracer_renderer.rs:364-375,
  684-695)
* refraction depth budgets shrink adaptively with opacity: step 2 below 0.5,
  initial divisor 3 below 0.3 / 2 below 0.5     (raytracer_renderer.rs:458-491)
* a child whose budget reaches 0 is never spawned (raytracer_renderer.rs:174-178)
* the combine rule: transmissive surfaces drop direct light, keeping
  reflection+refraction+specular              (raytracer_renderer.rs:251-257)
* reflection contributions are attenuated by the *child's* first-hit distance
  (raytracer_renderer.rs:711-728) -- tracked via the `from_refl` flag

The JAX package's single-device knobs of the pool: `packet_mode` (the
reference's SIMD build: eight consecutive lanes share spawn decisions, depth
budgets and the adaptive refraction step; `_node_children(packet=True)`, the
plain node on every scene) and `resort_secondary` (a Morton sort of each
serviced batch). `stage_mode` and `commit_splits` are accepted and change
nothing here: in the JAX package they pick how a TPU pays for the pool's
scatter and the chunk commit (the same rows, the same sums), and the port
always takes its one row scatter and one commit per chunk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from ..config import DEFAULT_REFRACTION_INDEX, RenderConfig
from ..scene.device import DeviceScene
from ..utils import timing as spans
from .intersect import _where0, cast_rays
from .shading import (
    attenuation_factor_based_on_distance,
    calculate_lighting,
    compute_fresnel,
)
from .vecmath import F32_EPSILON, dot, normalized, reflected, refracted

AIR = float(DEFAULT_REFRACTION_INDEX)
# |v|^2 threshold for `abs_diff_eq_default(zero)` on a direction vector
# (ref vector.rs componentwise F32_EPSILON check, used at rs:589-594)
F32_EPS_SQ = F32_EPSILON**2
# lanes of one packet in packet_mode: the 8 consecutive AA lanes of a pixel
PACKET = 8

# packed pool-entry layout: one (16,) f32 row per pending ray:
#   [0:3] o | [3:6] d | [6:9] w | [9] ior | [10] budget | [11] from_refl |
#   [12] pix | [13:16] pad
# budget/pix live exactly in f32: pool rows only ever hold real pixel
# indices (< R < 2^24) and small depth budgets.
PK_O, PK_D, PK_W = slice(0, 3), slice(3, 6), slice(6, 9)
PK_IOR, PK_BUD, PK_REFL, PK_PIX = 9, 10, 11, 12
POOL_COLS = 16


def _node_children(point, normal, color, metallic, has_trans, hior, opacity,
                   boost, t, hval, direct, spec, d, ior, weight, budget,
                   from_refl, eps_dist, *, reflections, refractions, refl_max,
                   refr_max, weight_cutoff, air=AIR, packet=False):
    """Everything `_eval_node` computes after lighting (JAX trace.py:95-219):
    the node contribution and the reflection / refraction child entries.
    Returns (contrib (R,3), refl_push, refr_push); a push is a dict of child
    fields + `mask`, or None for a disabled child type.

    `packet` (cfg.packet_mode, the reference's SIMD build; JAX
    trace.py:107-208): lanes [8p, 8p+8) form packet p. A child is spawned
    for the whole packet when any lane spawns it (rs:217, 232, 306-308,
    584-594), a reflection not at all when any lane's direction
    degenerated; lanes that would not spawn ride along with zero weight
    (the reference's final per-lane blends, rs:505-522, 712-729); the
    adaptive refraction step and divisor and the weight cutoff take the
    packet's largest opacity and weight (rs:458-491)."""
    dist_f = attenuation_factor_based_on_distance(t)
    dist_f = _where0(hval, dist_f)
    direct = direct * dist_f[:, None]
    spec = spec * dist_f[:, None]

    w = weight * torch.where(from_refl, dist_f, torch.ones_like(dist_f))[:, None]

    node_color = _where0(~has_trans[:, None], direct) + spec  # transmissive: no direct
    contrib = _where0(hval[:, None], w * node_color)

    cos_theta = dot(d, normal)
    air_t = torch.full_like(ior, air)

    def pk_any(m):  # packet-wide .any(), back on every lane
        return m.reshape(-1, PACKET).any(1, keepdim=True).expand(-1, PACKET).reshape(-1)

    def pk_max(x):  # simd_horizontal_max, back on every lane
        return x.reshape(-1, PACKET).amax(1, keepdim=True).expand(-1, PACKET).reshape(-1)

    # ---- reflection child (raytracer_renderer.rs:526-729) ----
    refl_push = None
    if reflections:
        is_inside = cos_theta < 0.0
        inormal = torch.where(is_inside[:, None], -normal, normal)
        new_ior = torch.where(is_inside, hior, air_t)
        eta = torch.where(is_inside, new_ior / ior, ior / new_ior)
        cos_i = torch.abs(cos_theta)
        sin2_t = eta * eta * (1.0 - cos_i * cos_i)
        tir = sin2_t >= 1.0
        reflective = (metallic > 0.0) | (has_trans & tir)

        refl_raw = reflected(d, normal)
        refl_dir = normalized(refl_raw)
        reflectance, _ = compute_fresnel(
            inormal, -d, ior, color, metallic, hior, has_trans
        )
        child_budget = torch.where(
            budget < 0, torch.full_like(budget, refl_max),
            torch.clamp(budget - 1, min=0),
        )
        refl_w = w * reflectance
        if packet:
            degen = dot(refl_raw, refl_raw) <= F32_EPS_SQ
            mask = pk_any(hval & reflective) & ~pk_any(degen) & (child_budget > 0)
            refl_w = _where0((hval & reflective & ~degen)[:, None], refl_w)
            if weight_cutoff > 0.0:
                mask = mask & (pk_max(torch.amax(refl_w, dim=1)) > weight_cutoff)
        else:
            mask = hval & reflective & (child_budget > 0)
            if weight_cutoff > 0.0:
                mask = mask & (torch.amax(refl_w, dim=1) > weight_cutoff)
        refl_push = dict(
            o=point + refl_dir * eps_dist,
            d=refl_dir,
            ior=ior,  # reflection keeps the current medium (rs:703)
            w=refl_w,
            budget=child_budget,
            from_refl=torch.ones_like(mask),
            mask=mask,
        )

    # ---- refraction child (raytracer_renderer.rs:279-524) ----
    refr_push = None
    if refractions:
        is_inside = cos_theta <= 0.0
        inormal = torch.where(is_inside[:, None], -normal, normal)
        new_ior = torch.where(is_inside, hior, air_t)
        eta = torch.where(is_inside, new_ior / ior, ior / new_ior)
        inv_eta = 1.0 / eta
        _, transmittance = compute_fresnel(
            inormal, d, inv_eta, color, metallic, hior, has_trans
        )
        refr_raw, k_pos = refracted(d, -inormal, inv_eta)
        refr_dir = _where0(k_pos[:, None], normalized(refr_raw))

        op = _where0(has_trans, opacity)
        if packet:
            op = pk_max(op)
        one = torch.ones_like(budget)
        step = torch.where(op < 0.5, 2 * one, one)
        divisor = torch.where(op <= 0.3, 3 * one, torch.where(op < 0.5, 2 * one, one))
        child_budget = torch.where(
            budget < 0,
            refr_max // divisor,
            torch.clamp(budget - step, min=0),
        )
        boost_f = _where0(has_trans, boost) + 1.0
        refr_w = w * transmittance * boost_f[:, None]
        if packet:
            # TIR lanes (k_pos false) keep a zero direction and weight
            mask = pk_any(hval & has_trans) & (child_budget > 0)
            refr_w = _where0((hval & has_trans & k_pos)[:, None], refr_w)
            if weight_cutoff > 0.0:
                mask = mask & (pk_max(torch.amax(refr_w, dim=1)) > weight_cutoff)
        else:
            mask = hval & has_trans & (child_budget > 0) & k_pos
            if weight_cutoff > 0.0:
                mask = mask & (torch.amax(refr_w, dim=1) > weight_cutoff)
        refr_push = dict(
            o=point + refr_dir * eps_dist,
            d=refr_dir,
            ior=new_ior,  # entering the new medium (rs:497)
            w=refr_w,
            budget=child_budget,
            from_refl=torch.zeros_like(mask),
            mask=mask,
        )

    return contrib, refl_push, refr_push


def _park(o, d, active):
    """Park inactive lanes on a far-away miss ray: keeps the math finite and
    lets the kernels' AABB gates skip them."""
    o = torch.where(active[:, None], o, torch.full_like(o, 1e9))
    zdir = torch.zeros_like(d)  # built on the device: no host copy, no sync
    zdir[:, 2] = 1.0
    d = torch.where(active[:, None], d, zdir)
    return o, d


def _cast_active(scene, cfg, o, d, active):
    o, d = _park(o, d, active)
    hit = cast_rays(scene, o, d, cfg.backface_culling)
    hval = hit.valid & active
    # park missed lanes far away too: their (masked-out) shadow rays then
    # miss every block AABB
    point = torch.where(hval[:, None], hit.point, torch.full_like(hit.point, 1e9))
    return hit, hval, point, d


def _node_args(scene, hit, hval, point, d, ior, weight, budget, from_refl):
    """The per-ray inputs of the node kernels (`shade_eval`,
    `shade_eval_rows` without `pix`), contiguous and in their dtypes."""
    f32 = torch.float32
    return (
        scene.light_pack, scene.sph_pack, scene.trb_pack,
        scene.tri_blk_pack, scene.tri_blk_aabb,
        point, hit.normal.contiguous(), d.contiguous(), hit.color.contiguous(),
        hit.shininess.contiguous(), hval.to(f32), hit.t.contiguous(),
        weight.contiguous(), ior.contiguous(), budget.to(torch.int32).contiguous(),
        from_refl.to(f32), hit.has_trans.to(f32), hit.metallic.contiguous(),
        hit.ior.contiguous(), hit.opacity.contiguous(), hit.boost.contiguous(),
    )


def _node_kw(scene, cfg: RenderConfig, eps_dist):
    return dict(
        n_lights=scene.n_lights,
        eps_dist=float(eps_dist),
        n_trans_blocks=scene.n_trans_blocks,
        backface_culling=cfg.backface_culling,
        bigtri_trans_rows=scene.bigtri_trans_rows,
        reflections=cfg.reflections,
        refractions=cfg.refractions,
        refl_max=int(cfg.reflection_max_depth),
        refr_max=int(cfg.refraction_max_depth),
        weight_cutoff=float(cfg.weight_cutoff),
        air=AIR,
    )


def _eval_node(scene, cfg: RenderConfig, eps_dist, o, d, ior, weight, budget,
               from_refl, active):
    """Evaluate one shading-tree node for the whole wavefront (JAX
    `_eval_node`): with reflections or refractions on a resident scene
    through the fused `shade_eval` kernel (JAX `_eval_node_fused`); else
    the plain node (JAX trace.py:93-219): lit through `calculate_lighting`
    (the `light_shade` kernel, or for a streamed scene the light loop over
    `occlude_rays`), children from `_node_children`. Packet mode takes the
    plain node on every scene (JAX trace.py:81-93): its reductions cross
    lanes, which the fused kernel does not.

    Returns (contribution (R,3), primary_hit_valid (R,), refl_push, refr_push);
    a push is a dict of child fields + `mask`, or None for a disabled child
    type."""
    hit, hval, point, d = _cast_active(scene, cfg, o, d, active)
    if (cfg.reflections or cfg.refractions) and not (scene.streaming or cfg.packet_mode):
        return _eval_node_fused(scene, cfg, eps_dist, hit, hval, point, d, ior,
                                weight, budget, from_refl)
    direct, spec = calculate_lighting(
        scene, cfg, dataclasses.replace(hit, valid=hval, point=point), d, eps_dist
    )
    contrib, refl_push, refr_push = _node_children(
        point, hit.normal, hit.color, hit.metallic, hit.has_trans, hit.ior,
        hit.opacity, hit.boost, hit.t, hval, direct, spec, d, ior, weight,
        budget, from_refl, eps_dist, reflections=cfg.reflections,
        refractions=cfg.refractions, refl_max=int(cfg.reflection_max_depth),
        refr_max=int(cfg.refraction_max_depth), weight_cutoff=float(cfg.weight_cutoff),
        packet=cfg.packet_mode,
    )
    return contrib, hval, refl_push, refr_push


def _eval_node_fused(scene, cfg: RenderConfig, eps_dist, hit, hval, point, d, ior,
                     weight, budget, from_refl):
    """Lighting + children through the `shade_eval` kernel (JAX
    `_eval_node_fused`). The kernel does not output what the caller knows:
    the reflection child keeps the input medium `ior`, and the from_refl
    flags are True for the reflection child and False for the refraction
    child."""
    from .kernels import shade_eval

    R = d.shape[0]
    contrib, refl, refr = shade_eval(
        *_node_args(scene, hit, hval, point, d, ior, weight, budget, from_refl),
        **_node_kw(scene, cfg, eps_dist),
    )
    refl_push = refr_push = None
    if cfg.reflections:
        refl_push = dict(refl, ior=ior,  # reflection keeps the current medium (rs:703)
                         from_refl=torch.ones((R,), dtype=torch.bool, device=d.device))
    if cfg.refractions:
        refr_push = dict(refr, from_refl=torch.zeros((R,), dtype=torch.bool, device=d.device))
    return contrib, hval, refl_push, refr_push


def _eval_node_rows(scene, cfg: RenderConfig, eps_dist, o, d, ior, weight,
                    budget, from_refl, active, pix):
    """One node evaluation with the PACKED pool-row epilogue: the cast, then
    the `shade_eval_rows` kernel (ops/kernels.py), which writes each child's
    (R, 16) pool rows directly. Returns (contrib, hval, rows (k*R, 16),
    masks (k*R,)) with children in the pool-append order [refr, refl]
    (k = number of enabled child types)."""
    from .kernels import shade_eval_rows

    hit, hval, point, d = _cast_active(scene, cfg, o, d, active)
    contrib, rfl_rows, rfl_m, rfr_rows, rfr_m = shade_eval_rows(
        *_node_args(scene, hit, hval, point, d, ior, weight, budget, from_refl),
        pix.to(torch.int32), **_node_kw(scene, cfg, eps_dist),
    )
    rows, masks = [], []
    if cfg.refractions:  # pool-append order: refr first
        rows.append(rfr_rows)
        masks.append(rfr_m)
    if cfg.reflections:
        rows.append(rfl_rows)
        masks.append(rfl_m)
    return contrib, hval, torch.cat(rows, dim=0), torch.cat(masks, dim=0)


def _node_rows(scene, cfg: RenderConfig, eps_dist, o, d, ior, weight, budget,
               from_refl, active, pix):
    """A pool node evaluation as (contrib, hval, rows, masks) in the
    pool-append order [refr, refl]: packed by the kernel
    (`_eval_node_rows`), or with `packed_stage=False`, a streamed scene or
    packet mode from the per-field children (`_eval_node`, then
    `_pack_entry`; JAX trace.py:592-595, 805-811, 866-871, 895-901)."""
    if cfg.packed_stage and not (scene.streaming or cfg.packet_mode):
        return _eval_node_rows(scene, cfg, eps_dist, o, d, ior, weight, budget,
                               from_refl, active, pix)
    contrib, hval, refl, refr = _eval_node(scene, cfg, eps_dist, o, d, ior, weight,
                                           budget, from_refl, active)
    pushes = [p for p in (refr, refl) if p is not None]
    return (contrib, hval, torch.cat([_pack_entry(p, pix) for p in pushes], dim=0),
            torch.cat([p["mask"] for p in pushes], dim=0))


def _pack_entry(e, pix):
    """Entry dict -> packed (N, 16) f32 rows."""
    n = pix.shape[0]
    f32 = torch.float32
    return torch.cat(
        [
            e["o"], e["d"], e["w"],
            e["ior"][:, None],
            e["budget"].to(f32)[:, None],
            e["from_refl"].to(f32)[:, None],
            pix.to(f32)[:, None],
            torch.zeros((n, 3), dtype=f32, device=pix.device),
        ],
        dim=1,
    )


def _unpack_entry(rows):
    """Packed rows -> entry dict (+ pix as int64)."""
    return dict(
        o=rows[:, PK_O],
        d=rows[:, PK_D],
        w=rows[:, PK_W],
        ior=rows[:, PK_IOR],
        budget=rows[:, PK_BUD].to(torch.int32),
        from_refl=rows[:, PK_REFL] != 0.0,
        pix=rows[:, PK_PIX].to(torch.int64),
    )


def _pool_append(pool, count, cand, m):
    """Compact the accepted candidate rows into the pool at `count` with ONE
    row scatter (JAX `_pool_append`, scatter mode; its gather and unique
    modes give the same rows): accepted row i goes to count + (rank of i
    among accepted rows); rejected rows go to the dump row at the end of
    `pool`. `count` stays on the device: no host sync. Rows above the new
    count are dead (never read as active)."""
    Q = pool.shape[0] - 1  # last row is the dump row
    cum = torch.cumsum(m.to(torch.int64), dim=0)
    dest = torch.where(m, count + cum - 1, torch.full_like(cum, Q))
    pool.index_copy_(0, dest, cand)
    return count + cum[-1]


def _morton_order(rows, active):
    """The serviced batch's order by the 18-bit Morton code of its origins
    (cfg.resort_secondary, JAX trace.py:842-858), dead lanes last, ties in
    lane order (`jnp.argsort` is stable)."""
    oq = torch.clamp(rows[:, PK_O] * 64.0, 0.0, 63.0).to(torch.int32)

    def spread(v):  # interleave 6 bits -> 18-bit morton
        v = (v | (v << 8)) & 0x0300F
        v = (v | (v << 4)) & 0x030C3
        return (v | (v << 2)) & 0x09249

    key = spread(oq[:, 0]) | (spread(oq[:, 1]) << 1) | (spread(oq[:, 2]) << 2)
    key = torch.where(active, key, torch.full_like(key, 2**30))
    return torch.argsort(key, stable=True)


def _splits_packets(m):
    """True (a device tensor) where some packet of the append mask `m` has
    accepted and rejected lanes."""
    pk = m.reshape(-1, PACKET)
    return (pk.any(1) != pk.all(1)).any()


class _PoolBuffers:
    """The pool loop's device state at width W, `chunk` iterations a chunk
    and logical capacity Q_cap: the pool (Q+1, 16) with its dump row,
    `count`, `dropped` and the packet `split` flag, the accumulator (R +
    chunk*W, 3) with a dump row per staging row, the chunk's staging rows and
    the lanes 0..W-1. A tile fills them, then each chunk updates them in
    place, so a CUDA graph of a chunk reads and writes the same memory at
    every replay."""

    def __init__(self, dev, R, W, chunk, Q, Q_cap):
        self.W, self.chunk, self.Q_cap = W, chunk, Q_cap
        f32, i64 = torch.float32, torch.int64
        self.pool = torch.empty((Q + 1, POOL_COLS), dtype=f32, device=dev)
        self.count = torch.empty((), dtype=i64, device=dev)
        self.dropped = torch.empty((), dtype=i64, device=dev)
        self.split = torch.empty((), dtype=torch.bool, device=dev)
        self.accum = torch.empty((R + chunk * W, 3), dtype=f32, device=dev)
        self.stage_pix = torch.empty((chunk * W,), dtype=i64, device=dev)
        self.stage_contrib = torch.empty((chunk * W, 3), dtype=f32, device=dev)
        self.lanes = torch.arange(W, dtype=i64, device=dev)


def _own_copies(values, keep):
    """`values` with every tensor whose data pointer is not in `keep`
    cloned."""
    return [v.clone() if isinstance(v, torch.Tensor) and v.data_ptr() not in keep else v
            for v in values]


def _cloned(out):
    """A swapped wrapper's outputs, every tensor cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_cloned(o) for o in out)
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    return out


def _refill(held, out):
    """Writes the outputs `out` of a swapped wrapper's call at a replay into
    those of its call at the capture, `held`, which the next graph reads."""
    if isinstance(held, torch.Tensor):
        held.copy_(out)
    elif isinstance(held, (tuple, list)):
        for h, o in zip(held, out, strict=True):
            _refill(h, o)
    elif isinstance(held, dict):
        for k, h in held.items():
            _refill(h, out[k])
    elif held != out:
        raise RuntimeError(f"a swapped kernel wrapper returned {out!r} at a replay "
                           f"where the chunk's capture got {held!r}")


_cutting = threading.Lock()  # one capture at a time cuts at the swapped wrappers


class _Captured:
    """A captured pool chunk: its CUDA graphs in order and, between each
    two, a call of a kernel wrapper that was swapped in when it was captured
    (`kernels.swapped_wrappers`: a hook that watches the calls, a stand-in).
    That is Python a graph would not run, so the capture ends a graph at
    each of its calls, and every replay makes the call eagerly between the
    graphs: on copies of the tensor arguments the graphs wrote (the next
    replay rewrites them; the scene's are passed as they are), its outputs
    copied into those the next graph reads, so what a hook keeps of a call
    stays as the call saw it. With no wrapper swapped a chunk is one graph.
    The graphs share one memory pool. `launches` counts the graphs'
    launches, added to `kernels.LAUNCHES` at the capture's run and at each
    replay; the eager calls count their own."""

    def __init__(self, swapped, scene):
        self.swapped = swapped
        self.graphs, self.calls, self.launches = [], [], {}
        self.keep = {v.data_ptr() for v in (getattr(scene, f.name)
                                            for f in dataclasses.fields(scene))
                     if isinstance(v, torch.Tensor)}

    def _call(self, fn, a, kw):
        from . import kernels

        with kernels.counting_into(None):
            return fn(*_own_copies(a, self.keep),
                      **dict(zip(kw, _own_copies(kw.values(), self.keep))))

    def capture(self, body, side):
        """Captures the chunk `body` on the stream `side` and runs it once,
        each graph replayed on the caller's stream as soon as it is
        captured."""
        from . import kernels

        caller = torch.cuda.current_stream(side.device)
        pool = torch.cuda.graph_pool_handle()
        me = threading.get_ident()
        open_graph = []

        def begin():
            open_graph.append(torch.cuda.CUDAGraph())
            # thread-local: a mesh entry captures while other entries launch
            open_graph[0].capture_begin(pool=pool, capture_error_mode="thread_local")

        def end():
            g = open_graph.pop()
            g.capture_end()
            self.graphs.append(g)
            with torch.cuda.stream(caller):
                g.replay()

        def cut(fn):
            def call(*a, **kw):
                if threading.get_ident() != me:
                    return fn(*a, **kw)
                end()
                with torch.cuda.stream(caller):
                    held = _cloned(self._call(fn, a, kw))
                self.calls.append((fn, a, kw, held))
                begin()
                return held
            return call

        with (_cutting if self.swapped else contextlib.nullcontext()), \
                torch.cuda.stream(side), kernels.counting_into(self.launches):
            for name, fn in self.swapped.items():
                setattr(kernels, name, cut(fn))
            begin()
            try:
                body()
            except BaseException:
                if open_graph:  # none is open when a call between graphs raised
                    open_graph.pop().capture_end()
                raise
            finally:
                for name, fn in self.swapped.items():
                    setattr(kernels, name, fn)
            end()
        kernels.count_launches(self.launches)
        return self

    def replay(self):
        from . import kernels

        for g, (fn, a, kw, held) in zip(self.graphs, self.calls):
            g.replay()
            _refill(held, self._call(fn, a, kw))
        self.graphs[-1].replay()
        kernels.count_launches(self.launches)


class _ChunkGraph:
    """One pool chunk of one (device, stream) as a CUDA graph. `key` names
    everything a chunk bakes in (`_graph_key`); while it holds, the buffers
    serve tile after tile. On a new key the first chunk runs eagerly, which
    loads the kernels and fills the wrappers' caches outside any capture;
    the next is captured (`_Captured`), then replayed, and every later one
    replayed. The capture holds for the kernel wrappers swapped in when it
    was made: once they change, the next chunk captures anew, cut at the
    calls of those swapped in now. A chunk run eagerly while a wrapper is
    swapped does not warm the entry (a stand-in may leave the module's own
    wrapper cold). `held` keeps the scene the graph reads alive, so its
    memory is not reused."""

    def __init__(self):
        self.lock = threading.Lock()  # one tile at a time on the buffers
        self.key = self.held = self.bufs = self.captured = self.side = None
        self.warm = False

    def buffers(self, key, held, dev, *shape):
        if key != self.key:
            self.key, self.held, self.captured, self.warm = key, held, None, False
            self.bufs = _PoolBuffers(dev, *shape)
        return self.bufs

    def run(self, body) -> bool:
        """One chunk, run eagerly, captured or replayed: whether replayed."""
        from . import kernels

        swapped = kernels.swapped_wrappers()
        if self.captured is not None and self.captured.swapped == swapped:
            self.captured.replay()
            return True
        if not self.warm:
            body()
            self.warm = not swapped
            return False
        self.captured = None  # its graphs and their pool go before the next capture
        if self.side is None:
            self.side = torch.cuda.Stream(self.bufs.lanes.device)
        self.captured = _Captured(swapped, self.held).capture(body, self.side)
        return False


_graphs: dict = {}  # (device index, stream) -> _ChunkGraph
_graphs_lock = threading.Lock()


def _chunk_graph(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _graphs_lock:
        return _graphs.setdefault((dev.index, stream), _ChunkGraph())


def drop_pool_graphs() -> None:
    """Forget every captured pool chunk and its buffers: the next chunk on
    each stream runs eagerly, then captures anew (a test that starts from
    nothing captured)."""
    with _graphs_lock:
        _graphs.clear()


def _graph_key(scene, cfg, eps_dist, *shape):
    """What a captured chunk bakes in: the shapes, the config (paths, depths,
    cutoffs, packet mode, resort), eps, the commit (a caller may swap it),
    the kernels' module settings, and the scene's tables by storage with
    its host fields."""
    from .kernels import launch_settings

    return (shape, cfg, float(eps_dist), _commit, launch_settings(), tuple(
        (v.data_ptr(), tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else v
        for v in (getattr(scene, f.name) for f in dataclasses.fields(scene))))


def _run_pool(scene, cfg, eps_dist, R, contrib, rows0, masks0):
    """Compacted wavefront with a dense LIFO ray pool (JAX `_run_pool`):
    each iteration services the top W pending rays, so its cost scales with
    W, not R. Exact: contributions carry path weights, so evaluation order
    is free. Returns (accum (R,3), dropped, unfinished), the two counts int64
    tensors: `dropped`, the rays a full pool refused (the JAX package's
    count); `unfinished`, the rays still in the pool when `max_iters` ended
    the loop, which no one traced (0 when the pool drained).

    The host reads `count` once per `loop_chunk` iterations, as the JAX
    while_loop condition does; inside a chunk every step is device-side
    index arithmetic (no host sync). Iterations after the pool drains are
    no-ops: every lane is inactive and stages a dead row. One commit per
    chunk, whatever `commit_splits` says (the JAX package's split commit
    gives the same sums).

    On a CUDA device a chunk is a CUDA graph (`_ChunkGraph`, one per device
    and stream): one launch and one read of `count` per chunk; while a
    kernel wrapper is swapped in, a graph between each two of its calls,
    which are made eagerly (`_Captured`). On the CPU the same chunk body
    runs eagerly on buffers of its own.

    In packet mode every append mask is packet-uniform, so the pool holds
    whole packets and each serviced window starts on a packet; that is
    checked on the device and read with `count`.

    While spans record (`utils/timing.py`), each chunk is a `pool.chunk`
    span (its iterations and its commit, enqueued or replayed; counters
    `iters`, `live_iters`, the iterations that found the pool non-empty,
    `lanes`, iters x W, `live_lanes`, the lanes that serviced a pending
    ray, and `graph`, 1 for a replayed chunk) and each read of `count`, the
    first before any chunk, a `pool.sync` span beside them; the chunk's
    staged pixels that give `live_iters` and their live count, computed
    outside the chunk's graph, are read with `count`."""
    ratio = max(int(cfg.compaction_ratio), 1)
    rt = int(cfg.kernel_ray_tile)
    W = max((R // ratio) // rt * rt, rt)
    # Pool capacity (JAX trace.py:777-798): the prologue pushes at most 2R
    # entries; the LIFO service loop adds at most one net +W band per budget
    # level; 2W headroom keeps a full append in bounds. Saturation is
    # counted in `dropped`, never silent.
    D = max(
        cfg.reflection_max_depth if cfg.reflections else 0,
        cfg.refraction_max_depth if cfg.refractions else 0,
        1,
    )
    Q = 2 * R + 2 * W * (D + 2)
    Q_cap = Q
    if cfg.pool_capacity:
        Q_cap = min(max(int(cfg.pool_capacity), 2 * W), Q)
    packet = cfg.packet_mode
    if packet and (W % PACKET or Q_cap % PACKET):
        raise ValueError(f"packet_mode needs a pool width ({W}) and capacity ({Q_cap}) "
                         f"in whole packets of {PACKET}")

    dev = contrib.device
    shape = (R, W, max(int(cfg.loop_chunk), 1), Q, Q_cap)
    g = _chunk_graph(dev) if dev.type == "cuda" else None
    with g.lock if g else contextlib.nullcontext():
        b = (g.buffers(_graph_key(scene, cfg, eps_dist, *shape), scene, dev, *shape) if g
             else _PoolBuffers(dev, *shape))
        return _pool_loop(scene, cfg, eps_dist, contrib, rows0, masks0, b, g)


def _pool_loop(scene, cfg, eps_dist, contrib, rows0, masks0, b, g):
    """`_run_pool`'s loop on the buffers `b`, its chunks through the graph
    `g` (None: eagerly). Returns copies, never the buffers: the next tile
    refills them."""
    R = contrib.shape[0]
    W, chunk, Q_cap = b.W, b.chunk, b.Q_cap
    k = rows0.shape[0] // R  # enabled child types (1 or 2)
    packet = cfg.packet_mode
    # the tile's state: an empty pool, the prologue's rows appended. Per-chunk
    # contribution staging: iteration i writes its (W, 3) contributions at
    # rows [i*W, (i+1)*W) and ONE `_commit` per chunk adds them. A dead
    # staging row s points at its own dump row R + s of the accumulator:
    # rows that share a target are summed one after another by one thread
    # in the sorted commit, so the (mostly dead) rows of a drained pool must
    # not all share one
    b.pool.zero_()
    count = _pool_append(b.pool, 0, rows0, masks0)
    torch.clamp(count - Q_cap, min=0, out=b.dropped)
    torch.clamp(count, max=Q_cap, out=b.count)
    if packet:
        b.split.copy_(_splits_packets(masks0))
    b.accum[:R].copy_(contrib)
    b.accum[R:].zero_()
    lanes = b.lanes

    def run_chunk():
        """`chunk` iterations and their commit, on the buffers alone; the
        counts rebound per iteration are written back at the end."""
        count, dropped, split = b.count, b.dropped, b.split
        for slot in range(chunk):
            start = torch.clamp(count - W, min=0)
            idx = start + lanes
            sel_active = idx < count
            rows = b.pool.index_select(0, idx)
            if cfg.resort_secondary:
                order = _morton_order(rows, sel_active)
                rows, sel_active = rows[order], sel_active[order]
            e = _unpack_entry(rows)
            contrib_w, _, rows_b, masks_b = _node_rows(
                scene, cfg, eps_dist, e["o"], e["d"], e["ior"], e["w"],
                e["budget"], e["from_refl"], sel_active, pix=e["pix"],
            )
            rows_sl = slice(slot * W, (slot + 1) * W)
            b.stage_pix[rows_sl] = torch.where(sel_active, e["pix"], R + slot * W + lanes)
            b.stage_contrib[rows_sl] = _where0(sel_active[:, None], contrib_w)
            # cap so a full append of 2W candidates stays within the logical
            # capacity; at the auto capacity this never engages
            capped = torch.clamp(start, max=Q_cap - 2 * W)
            dropped = dropped + (start - capped)
            m = masks_b & sel_active.repeat(k)
            if packet:
                split = split | _splits_packets(m)
            count = _pool_append(b.pool, capped, rows_b, m)
        _commit(b.accum, b.stage_pix, b.stage_contrib)
        b.count.copy_(count)
        b.dropped.copy_(dropped)
        if packet:
            b.split.copy_(split)

    def host_read(after_chunk=False):
        """The chunk's one sync, a `pool.sync` span: count, with the packet
        check and, while spans record, the chunk's live iterations and live
        lanes read beside it. Returns (count, live iterations, live lanes),
        the last two None unless spans record."""
        # a staged row is live when it holds a real pixel (< R); slot s found
        # the pool non-empty exactly when its lane 0 was live
        live = after_chunk and spans.ON
        with spans.span("pool.sync"):
            if packet or live:
                got = torch.cat([b.count.view(1)]
                                + ([b.split.to(torch.int64).view(1)] if packet else [])
                                + ([(b.stage_pix < R).sum().view(1), b.stage_pix[::W]]
                                   if live else [])).tolist()
            else:
                got = [int(b.count)]
        if packet and (got[1] or got[0] % PACKET):
            raise RuntimeError(f"the pool split a packet of {PACKET} lanes (count {got[0]})")
        if not live:
            return got[0], None, None
        return got[0], sum(p < R for p in got[-chunk:]), got[-chunk - 1]

    max_iters = cfg.max_nodes * max(int(cfg.compaction_ratio), 1)
    n_pending, _, _ = host_read()
    it = 0
    while it < max_iters and n_pending > 0:
        with spans.span("pool.chunk", iters=chunk, lanes=chunk * W) as sp_chunk:
            if g is None:
                run_chunk()
            sp_chunk.counters["graph"] = int(g is not None and g.run(run_chunk))
        it += chunk
        n_pending, live_iters, live_lanes = host_read(after_chunk=True)
        sp_chunk.counters.update(live_iters=live_iters, live_lanes=live_lanes)
    return b.accum[:R].clone(), b.dropped.clone(), b.count.clone()


def _commit(accum, pix, contrib):
    """accum[pix] += contrib with the same f32 sums on every run. On the
    card `index_put_(accumulate=True)` sorts the rows by pixel (a radix
    sort, stable) and sums the rows of each pixel in one thread in that
    fixed order, so its time grows with the largest number of rows that
    share a pixel; `index_add_` there adds with atomics, whose order, and so
    whose f32 result, changes from run to run. On the CPU `index_add_` adds
    in row order, as the JAX scatter-add does."""
    if accum.is_cuda:
        accum.index_put_((pix,), contrib, accumulate=True)
    else:
        accum.index_add_(0, pix, contrib)


def _push(stack, sp, dropped, entry, lanes):
    """Masked per-ray stack push (JAX `_push`). `stack` holds K slots per
    ray as packed (16,) rows, slot k of ray r at row k*R + r. A push into a
    full stack is counted in `dropped` (never silent). Returns (sp,
    dropped); `stack` is updated in place."""
    if entry is None:
        return sp, dropped
    R = lanes.shape[0]
    K = stack.shape[0] // R
    ok = entry["mask"] & (sp < K)
    dropped = dropped + (entry["mask"] & (sp >= K)).sum()
    at = torch.clamp(sp, max=K - 1) * R + lanes
    rows = torch.where(ok[:, None], _pack_entry(entry, lanes), stack.index_select(0, at))
    stack.index_copy_(0, at, rows)  # one row per ray: no two writes collide
    return sp + ok.to(sp.dtype), dropped


def _pop(stack, sp, lanes):
    """Pop every ray's top entry (JAX `_pop`): returns (entry, active, sp);
    a ray with an empty stack pops slot 0 as an inactive lane, which
    `_eval_node` parks."""
    R = lanes.shape[0]
    active = sp > 0
    e = _unpack_entry(stack.index_select(0, torch.clamp(sp - 1, min=0) * R + lanes))
    return e, active, torch.clamp(sp - 1, min=0)


def _run_stack(scene, cfg, eps_dist, contrib, refl_push, refr_push):
    """Full-width per-ray DFS (JAX trace.py:631-670 with `_body_full`): every
    iteration pops one entry per ray, evaluates the whole wavefront and
    pushes the children, refraction first so that the reflection child pops
    first (the reference evaluates the reflection subtree before the
    refraction subtree). Returns (accum (R,3), dropped, unfinished), the
    counts as `_run_pool`'s (unfinished: the entries left on the stacks when
    `max_nodes` ended the loop).

    The stop condition `it < max_nodes` is checked once per `loop_chunk`
    iterations, as the JAX while_loop condition is; inside a chunk an
    iteration runs only while some stack is not empty (the JAX in-chunk
    guard). So a tile runs up to ceil(max_nodes / loop_chunk) * loop_chunk
    iterations. The host reads `any(sp > 0)` once per iteration."""
    R = contrib.shape[0]
    dev = contrib.device
    lanes = torch.arange(R, dtype=torch.int64, device=dev)
    stack = torch.zeros((cfg.stack_size * R, POOL_COLS), dtype=torch.float32, device=dev)
    sp = torch.zeros((R,), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    sp, dropped = _push(stack, sp, dropped, refr_push, lanes)
    sp, dropped = _push(stack, sp, dropped, refl_push, lanes)
    accum = contrib
    chunk = max(int(cfg.loop_chunk), 1)
    it = 0
    live = bool((sp > 0).any())
    while live and it < cfg.max_nodes:
        for _ in range(chunk):
            e, active, sp = _pop(stack, sp, lanes)
            c, _, refl_p, refr_p = _eval_node(
                scene, cfg, eps_dist, e["o"], e["d"], e["ior"], e["w"], e["budget"],
                e["from_refl"], active,
            )
            accum = accum + c
            sp, dropped = _push(stack, sp, dropped, refr_p, lanes)
            sp, dropped = _push(stack, sp, dropped, refl_p, lanes)
            it += 1
            live = bool((sp > 0).any())
            if not live:
                break
    return accum, dropped, sp.sum()


def trace_rays(scene: DeviceScene, cfg: RenderConfig, origins, directions,
               with_stats: bool = False):
    """Trace R rays to final linear-RGB colors.

    `directions` need not be normalized (Ray::new normalizes, ray.rs:54).
    Returns (color (R,3), valid (R,)) -- `valid` is the primary-hit mask. With
    `with_stats=True` a third element is returned: {"dropped": int64 tensor,
    the number of pending secondary rays truncated by pool or stack capacity
    (0 in healthy runs; the reference recursion never drops subtrees);
    "unfinished": int64 tensor, the secondary rays left untraced when the
    loop's iteration cap (`max_nodes`) ended it (0 when a frame ran to its
    depth; the JAX package does not count them)}."""
    R = origins.shape[0]
    if cfg.packet_mode:
        # packets are 8 consecutive lanes; the pool keeps them whole (masks
        # are packet-uniform; checked in `_run_pool`), a Morton resort
        # would scatter them (JAX trace.py:567-572)
        if R % PACKET:
            raise ValueError(f"packet_mode needs wavefronts of whole {PACKET}-lane packets, "
                             f"got {R} rays")
        if cfg.resort_secondary:
            raise ValueError("packet_mode forbids resort_secondary")
    ratio = max(int(cfg.compaction_ratio), 1)
    children = cfg.reflections or cfg.refractions
    # >=: a tile of exactly kernel_ray_tile * ratio rays takes the pool path
    pool_path = children and ratio > 1 and R >= cfg.kernel_ray_tile * ratio

    eps_dist = float(cfg.camera.epsilon_distance)
    dev = origins.device
    # primary node: budget None (-1), weight 1, current medium = air
    prim = (
        origins,
        normalized(directions),
        torch.full((R,), AIR, dtype=torch.float32, device=dev),
        torch.ones((R, 3), dtype=torch.float32, device=dev),
        torch.full((R,), -1, dtype=torch.int32, device=dev),
        torch.zeros((R,), dtype=torch.bool, device=dev),
        torch.ones((R,), dtype=torch.bool, device=dev),
    )
    if pool_path:
        contrib, top_valid, rows0, masks0 = _node_rows(
            scene, cfg, eps_dist, *prim,
            pix=torch.arange(R, dtype=torch.int64, device=dev),
        )
        accum, dropped, unfinished = _run_pool(scene, cfg, eps_dist, R, contrib, rows0, masks0)
    else:
        contrib, top_valid, refl_push, refr_push = _eval_node(scene, cfg, eps_dist, *prim)
        if children:
            accum, dropped, unfinished = _run_stack(scene, cfg, eps_dist, contrib, refl_push,
                                                    refr_push)
        else:
            accum = contrib
            dropped = unfinished = torch.zeros((), dtype=torch.int64, device=dev)
    if with_stats:
        return accum, top_valid, {"dropped": dropped, "unfinished": unfinished}
    return accum, top_valid


def encode_pixels_u32(color, valid, aa_weights):
    """Fused AA reduction + pixel encode for one tile's (T, 3) colors and
    (T,) valid mask, T = pixels * U consecutive weighted AA samples:
    weighted sample sum (misses add black, ref rs:1001-1015), round-half-up
    u8 with NO gamma (output/file.rs:61-71), 0xFFRRGGBB pack
    (image_buffer.rs:10-15); all-miss pixels encode 0 like an untouched
    atomic. Returns int64 values in [0, 2^32) (torch has no full uint32
    arithmetic); callers cast to uint32 on the host."""
    U = aa_weights.shape[0]
    P = color.shape[0] // U
    c = color.reshape(P, U, 3)
    v = valid.reshape(P, U)
    px_c = torch.sum(_where0(v[..., None], c) * aa_weights[None, :, None], dim=1)
    px_v = torch.any(v, dim=1)
    u8 = torch.floor(torch.clamp(px_c, 0.0, 1.0) * 255.0 + 0.5).to(torch.int64)
    packed = (0xFF << 24) | (u8[:, 0] << 16) | (u8[:, 1] << 8) | u8[:, 2]
    return _where0(px_v, packed)


def make_raygen_per_tile(scene: DeviceScene, cfg: RenderConfig, offsets,
                         aa_weights, pix_t: int, with_stats: bool = False):
    """Per-tile body of the device-side ray-generation path: (pix_t,) int
    tile-major pixel indices (-1 = padding) -> (u32 pixels (pix_t,) as
    int64, dropped), with `with_stats` also unfinished (`trace_rays`). The
    same f32 ops in the same order as the JAX body."""
    U = offsets.shape[0]
    cam = cfg.camera
    dev = offsets.device
    focus = torch.tensor(cam.render_ray_focus, dtype=torch.float32, device=dev)
    zdir = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    w2s_w = torch.tensor(cam.w2s_width, dtype=torch.float32, device=dev)
    w2s_h = torch.tensor(cam.w2s_height, dtype=torch.float32, device=dev)

    def per_tile(og_t):
        pad = og_t < 0
        idx = torch.clamp(og_t, min=0)
        px = (idx % cfg.width).to(torch.float32) * w2s_w
        py = torch.div(idx, cfg.width, rounding_mode="floor").to(torch.float32) * w2s_h
        coords = torch.stack([px, py, torch.zeros_like(px)], dim=-1)  # (P, 3)
        dirs = coords - focus[None, :]
        o = coords[:, None, :] + offsets[None, :, :]  # (P, U, 3)
        d = dirs[:, None, :].expand(pix_t, U, 3)
        o = _where0(~pad[:, None, None], o).reshape(pix_t * U, 3)
        d = torch.where(
            pad[:, None, None], zdir[None, None, :].expand(pix_t, U, 3), d
        ).reshape(pix_t * U, 3)
        color, valid, stats = trace_rays(scene, cfg, o, d, with_stats=True)
        u32 = encode_pixels_u32(color, valid, aa_weights)
        if with_stats:
            return u32, stats["dropped"], stats["unfinished"]
        return u32, stats["dropped"]

    return per_tile


def _stack_tiles(outs):
    """Per-tile results (u32, counts...) stacked into (u32 (n_tiles, P),
    each count (n_tiles,))."""
    return tuple(torch.stack(parts) for parts in zip(*outs))


def trace_rays_tiled_u32_gen(scene: DeviceScene, cfg: RenderConfig,
                             order_group, offsets, aa_weights, n_tiles: int,
                             with_stats: bool = False):
    """Trace `n_tiles` tiles with device-side ray generation and pixel
    encode. order_group: (n_tiles * P,) tile-major row-major pixel indices,
    -1 marks padding slots beyond the frame. Returns (u32 (n_tiles, P) as
    int64, dropped (n_tiles,) int64), all on the device; with `with_stats`
    also unfinished (n_tiles,) int64 (`trace_rays`)."""
    P = order_group.shape[0] // n_tiles
    per_tile = make_raygen_per_tile(scene, cfg, offsets, aa_weights, P, with_stats)
    outs = []
    for og in order_group.reshape(n_tiles, P):
        with spans.span("tile"):
            outs.append(per_tile(og))
    return _stack_tiles(outs)


def trace_rays_tiled(scene: DeviceScene, cfg: RenderConfig, o_tiles, d_tiles,
                     with_stats: bool = False):
    """Trace (n_tiles, T, 3) ray tiles one after another. Returns color
    (n_tiles, T, 3) and valid (n_tiles, T); with `with_stats=True` also
    {"dropped", "unfinished": each count summed over the tiles}."""
    outs = [trace_rays(scene, cfg, o, d, with_stats=True) for o, d in zip(o_tiles, d_tiles)]
    color = torch.stack([c for c, _, _ in outs])
    valid = torch.stack([v for _, v, _ in outs])
    if with_stats:
        return color, valid, {k: torch.stack([s[k] for _, _, s in outs]).sum()
                              for k in ("dropped", "unfinished")}
    return color, valid


def trace_rays_tiled_u32(scene: DeviceScene, cfg: RenderConfig, o_tiles, d_tiles,
                         aa_weights, with_stats: bool = False):
    """`trace_rays_tiled` with the AA reduction and pixel encode on the
    device: each tile's T rays are U = len(aa_weights) consecutive samples
    per pixel. Returns (u32 (n_tiles, T // U) as int64, dropped (n_tiles,)
    int64), with `with_stats` also unfinished (n_tiles,), as
    `trace_rays_tiled_u32_gen` does for device-built rays."""
    outs = []
    for o, d in zip(o_tiles, d_tiles):
        with spans.span("tile"):
            color, valid, stats = trace_rays(scene, cfg, o, d, with_stats=True)
            counts = ("dropped", "unfinished") if with_stats else ("dropped",)
            outs.append((encode_pixels_u32(color, valid, aa_weights),
                         *(stats[k] for k in counts)))
    return _stack_tiles(outs)
