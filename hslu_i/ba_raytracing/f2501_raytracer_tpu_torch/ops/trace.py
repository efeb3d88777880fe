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

Not ported yet (they raise NotImplementedError; ROADMAP.md Queue 1):
packet_mode, resort_secondary, the gather/unique stage modes,
commit_splits > 1 and streamed scenes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import DEFAULT_REFRACTION_INDEX, RenderConfig
from ..scene.device import DeviceScene
from .intersect import _where0, cast_rays
from .shading import (
    attenuation_factor_based_on_distance,
    calculate_lighting,
    compute_fresnel,
)
from .vecmath import normalized, reflected, refracted

AIR = float(DEFAULT_REFRACTION_INDEX)

# packed pool-entry layout: one (16,) f32 row per pending ray:
#   [0:3] o | [3:6] d | [6:9] w | [9] ior | [10] budget | [11] from_refl |
#   [12] pix | [13:16] pad
# budget/pix live exactly in f32: pool rows only ever hold real pixel
# indices (< R < 2^24) and small depth budgets.
PK_O, PK_D, PK_W = slice(0, 3), slice(3, 6), slice(6, 9)
PK_IOR, PK_BUD, PK_REFL, PK_PIX = 9, 10, 11, 12
POOL_COLS = 16

_NOT_IN_SLICE = "is not ported yet (ROADMAP.md, Queue 1)"


def _node_children(point, normal, color, metallic, has_trans, hior, opacity,
                   boost, t, hval, direct, spec, d, ior, weight, budget,
                   from_refl, eps_dist, *, reflections, refractions, refl_max,
                   refr_max, weight_cutoff, air=AIR):
    """Everything `_eval_node` computes after lighting (JAX trace.py:95-219,
    non-packet): the node contribution and the reflection / refraction
    child entries. Returns (contrib (R,3), refl_push, refr_push); a push is
    a dict of child fields + `mask`, or None for a disabled child type."""
    dist_f = attenuation_factor_based_on_distance(t)
    dist_f = _where0(hval, dist_f)
    direct = direct * dist_f[:, None]
    spec = spec * dist_f[:, None]

    w = weight * torch.where(from_refl, dist_f, torch.ones_like(dist_f))[:, None]

    node_color = _where0(~has_trans[:, None], direct) + spec  # transmissive: no direct
    contrib = _where0(hval[:, None], w * node_color)

    p = d * normal
    cos_theta = (p[:, 0] + p[:, 1]) + p[:, 2]
    air_t = torch.full_like(ior, air)

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

        refl_dir = normalized(reflected(d, normal))
        reflectance, _ = compute_fresnel(
            inormal, -d, ior, color, metallic, hior, has_trans
        )
        child_budget = torch.where(
            budget < 0, torch.full_like(budget, refl_max),
            torch.clamp(budget - 1, min=0),
        )
        refl_w = w * reflectance
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
    `_eval_node`, non-packet): with reflections or refractions through the
    fused `shade_eval` kernel (JAX `_eval_node_fused`), else lit through
    `calculate_lighting` (the `light_shade` kernel) with no children.

    Returns (contribution (R,3), primary_hit_valid (R,), refl_push, refr_push);
    a push is a dict of child fields + `mask`, or None for a disabled child
    type."""
    if cfg.packet_mode:
        raise NotImplementedError("packet_mode " + _NOT_IN_SLICE)
    hit, hval, point, d = _cast_active(scene, cfg, o, d, active)
    if cfg.reflections or cfg.refractions:
        return _eval_node_fused(scene, cfg, eps_dist, hit, hval, point, d, ior,
                                weight, budget, from_refl)
    direct, spec = calculate_lighting(
        scene, cfg, dataclasses.replace(hit, valid=hval, point=point), d, eps_dist
    )
    contrib, _, _ = _node_children(
        point, hit.normal, hit.color, hit.metallic, hit.has_trans, hit.ior,
        hit.opacity, hit.boost, hit.t, hval, direct, spec, d, ior, weight,
        budget, from_refl, eps_dist, reflections=False, refractions=False,
        refl_max=0, refr_max=0, weight_cutoff=0.0,
    )
    return contrib, hval, None, None


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
    (`_eval_node_rows`), or with `packed_stage=False` from the per-field
    children (`_eval_node`, then `_pack_entry`; JAX trace.py:805-811,
    866-871, 895-901)."""
    if cfg.packed_stage:
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
    row scatter (JAX `_pool_append`, scatter mode): accepted row i goes to
    count + (rank of i among accepted rows); rejected rows go to the dump
    row at the end of `pool`. `count` stays on the device: no host sync.
    Rows above the new count are dead (never read as active)."""
    Q = pool.shape[0] - 1  # last row is the dump row
    cum = torch.cumsum(m.to(torch.int64), dim=0)
    dest = torch.where(m, count + cum - 1, torch.full_like(cum, Q))
    pool.index_copy_(0, dest, cand)
    return count + cum[-1]


def _run_pool(scene, cfg, eps_dist, R, contrib, rows0, masks0):
    """Compacted wavefront with a dense LIFO ray pool (JAX `_run_pool`,
    commit_splits=1): each iteration services the top W pending rays, so its
    cost scales with W, not R. Exact: contributions carry path weights, so
    evaluation order is free. Returns (accum (R,3), dropped int64 tensor).

    The host reads `count` once per `loop_chunk` iterations, as the JAX
    while_loop condition does; inside a chunk every step is device-side
    index arithmetic (no host sync). Iterations after the pool drains are
    no-ops: every lane is inactive and stages a dead row."""
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

    dev = contrib.device
    pool = torch.zeros((Q + 1, POOL_COLS), dtype=torch.float32, device=dev)
    count = _pool_append(pool, torch.zeros((), dtype=torch.int64, device=dev),
                         rows0, masks0)
    dropped = torch.clamp(count - Q_cap, min=0)
    count = torch.clamp(count, max=Q_cap)

    max_iters = cfg.max_nodes * ratio
    chunk = max(int(cfg.loop_chunk), 1)
    # per-chunk contribution staging: iteration i writes its (W, 3)
    # contributions at rows [i*W, (i+1)*W) and ONE `_commit` per chunk adds
    # them. A dead staging row s points at its own dump row R + s of the
    # accumulator: rows that share a target are summed one after another by
    # one thread in the sorted commit, so the (mostly dead) rows of a
    # drained pool must not all share one
    accum = torch.cat([contrib, torch.zeros((chunk * W, 3), dtype=contrib.dtype, device=dev)])
    stage_pix = torch.empty((chunk * W,), dtype=torch.int64, device=dev)
    stage_contrib = torch.empty((chunk * W, 3), dtype=torch.float32, device=dev)
    lanes = torch.arange(W, dtype=torch.int64, device=dev)
    k = rows0.shape[0] // R  # enabled child types (1 or 2)

    it = 0
    while it < max_iters and int(count) > 0:
        for slot in range(chunk):
            start = torch.clamp(count - W, min=0)
            idx = start + lanes
            sel_active = idx < count
            e = _unpack_entry(pool.index_select(0, idx))
            contrib_w, _, rows_b, masks_b = _node_rows(
                scene, cfg, eps_dist, e["o"], e["d"], e["ior"], e["w"],
                e["budget"], e["from_refl"], sel_active, pix=e["pix"],
            )
            rows_sl = slice(slot * W, (slot + 1) * W)
            stage_pix[rows_sl] = torch.where(sel_active, e["pix"], R + slot * W + lanes)
            stage_contrib[rows_sl] = _where0(sel_active[:, None], contrib_w)
            # cap so a full append of 2W candidates stays within the logical
            # capacity; at the auto capacity this never engages
            capped = torch.clamp(start, max=Q_cap - 2 * W)
            dropped = dropped + (start - capped)
            count = _pool_append(pool, capped, rows_b, masks_b & sel_active.repeat(k))
            it += 1
        _commit(accum, stage_pix, stage_contrib)
    return accum[:R], dropped


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
    refraction subtree). Returns (accum (R,3), dropped int64 tensor).

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
    return accum, dropped


def trace_rays(scene: DeviceScene, cfg: RenderConfig, origins, directions,
               with_stats: bool = False):
    """Trace R rays to final linear-RGB colors.

    `directions` need not be normalized (Ray::new normalizes, ray.rs:54).
    Returns (color (R,3), valid (R,)) -- `valid` is the primary-hit mask. With
    `with_stats=True` a third element is returned: {"dropped": int64 tensor},
    the number of pending secondary rays truncated by pool or stack capacity
    (0 in healthy runs; the reference recursion never drops subtrees)."""
    R = origins.shape[0]
    ratio = max(int(cfg.compaction_ratio), 1)
    children = cfg.reflections or cfg.refractions
    # >=: a tile of exactly kernel_ray_tile * ratio rays takes the pool path
    pool_path = children and ratio > 1 and R >= cfg.kernel_ray_tile * ratio
    if cfg.packet_mode:
        raise NotImplementedError("packet_mode " + _NOT_IN_SLICE)
    if scene.streaming:
        raise NotImplementedError("streamed scenes " + _NOT_IN_SLICE)
    if pool_path and cfg.resort_secondary:
        raise NotImplementedError("resort_secondary " + _NOT_IN_SLICE)
    if pool_path and cfg.stage_mode != "scatter":
        raise NotImplementedError(f"stage_mode={cfg.stage_mode!r} " + _NOT_IN_SLICE)
    if pool_path and int(cfg.commit_splits) != 1:
        raise NotImplementedError("commit_splits > 1 " + _NOT_IN_SLICE)

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
        accum, dropped = _run_pool(scene, cfg, eps_dist, R, contrib, rows0, masks0)
    else:
        contrib, top_valid, refl_push, refr_push = _eval_node(scene, cfg, eps_dist, *prim)
        if children:
            accum, dropped = _run_stack(scene, cfg, eps_dist, contrib, refl_push, refr_push)
        else:
            accum, dropped = contrib, torch.zeros((), dtype=torch.int64, device=dev)
    if with_stats:
        return accum, top_valid, {"dropped": dropped}
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
                         aa_weights, pix_t: int):
    """Per-tile body of the device-side ray-generation path: (pix_t,) int
    tile-major pixel indices (-1 = padding) -> (u32 pixels (pix_t,) as
    int64, dropped). The same f32 ops in the same order as the JAX body."""
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
        return encode_pixels_u32(color, valid, aa_weights), stats["dropped"]

    return per_tile


def trace_rays_tiled_u32_gen(scene: DeviceScene, cfg: RenderConfig,
                             order_group, offsets, aa_weights, n_tiles: int):
    """Trace `n_tiles` tiles with device-side ray generation and pixel
    encode. order_group: (n_tiles * P,) tile-major row-major pixel indices,
    -1 marks padding slots beyond the frame. Returns (u32 (n_tiles, P) as
    int64, dropped (n_tiles,) int64), all on the device."""
    P = order_group.shape[0] // n_tiles
    per_tile = make_raygen_per_tile(scene, cfg, offsets, aa_weights, P)
    outs = [per_tile(og) for og in order_group.reshape(n_tiles, P)]
    return torch.stack([u for u, _ in outs]), torch.stack([dr for _, dr in outs])
