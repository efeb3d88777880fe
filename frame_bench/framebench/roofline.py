"""The roofline yardstick: the card's published peaks and the operations and
bytes a shading-kernel call needs on its inputs.

A frozen copy of the repository's kernel arithmetic (`chip_smoke.py`'s
`shade_ops` and `OPS_*`, `utils/harness.py`'s peaks, `bound_ms` and
`gate_hits`), rewritten to take a call's own argument tensors and to import
nothing of the system under test. The pack layouts it reads are the kernels'
inputs: the sphere pack (S, 16) [centre, r^2, ior, opacity, metallic,
colour.r, transmissive, absorption, valid], the big-triangle pack and each
Morton block (n, 32) [Woop 0-11, |n|^2 12, valid 13, transmissive 14, ...],
block boxes (nb, 6) and the light pack (L, >= 3) positions.
"""

from __future__ import annotations

import torch

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, HBM bandwidth; both at the card's full 700 W power limit
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations (mul, add, div, sqrt) per test, counted from the kernels'
# sources: Woop triangle test, sphere shadow test with its normal, per
# (ray, light) set-up, per-ray epilogue of the node kernel (both children)
# and of the light kernel (its stores)
OPS_TRI, OPS_SPHERE, OPS_LIGHT = 40, 48, 60
OPS_EPILOGUE = {"shade_eval_rows": 200, "light_shade": 6}
F32_EPS = float(2.0**-23)


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def gate_hits(boxes, o, d, t_limit):
    """(N, n_boxes): does the segment [0, t_limit] cross each box (the
    kernels' widened slab test)?"""
    inv = 1.0 / d
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    m = 1e-5 * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    t1 = (lo - m - o[:, None, :]) * inv[:, None, :]
    t2 = (hi + m - o[:, None, :]) * inv[:, None, :]
    nan = torch.isnan(t1) | torch.isnan(t2)
    a = torch.where(nan, -float("inf"), torch.minimum(t1, t2)).amax(-1)
    b = torch.where(nan, float("inf"), torch.maximum(t1, t2)).amin(-1)
    return (b >= a.clamp(min=0)) & (a <= t_limit[:, None])


def _sphere_ts(center, r_sq, valid, o, d):
    oc = o[:, None, :] - center[None, :, :]
    b = 2.0 * (d[:, None, :] * oc).sum(-1)
    c = (oc * oc).sum(-1) - r_sq[None, :]
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = (-b - sq) * 0.5, (-b + sq) * 0.5
    t0v, t1v = (t0 >= 0.0) & (disc >= 0.0), (t1 >= 0.0) & (disc >= 0.0)
    use0 = t0v & (~t1v | (t0 < t1))
    use1 = t1v & ~use0
    t = torch.where(use0, t0, torch.where(use1, t1, torch.full_like(t0, float("inf"))))
    return t, (use0 | use1) & valid[None, :]


def _woop_ts(pack, o, d):
    """(N, n) distances and validity of the Woop test over one pack."""
    w = pack[:, 0:12].T.reshape(4, 3, -1)
    o4 = torch.cat([o, torch.ones_like(o[:, :1])], 1)

    def comp(vec, rows, c):
        acc = vec[:, 0:1] * rows[0, c][None, :]
        for k in range(1, vec.shape[1]):
            acc = acc + vec[:, k:k + 1] * rows[k, c][None, :]
        return acc

    u_o, v_o, w_o = (comp(o4, w, c) for c in range(3))
    u_d, v_d, w_d = (comp(d, w[:3], c) for c in range(3))
    t = -w_o / w_d
    u, v = u_o + t * u_d, v_o + t * v_d
    ok = ((t > F32_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v < 1.0)
          & (torch.abs(w_d * pack[:, 12][None, :]) > F32_EPS) & (pack[None, :, 13] != 0.0))
    return t, ok


def shade_ops(kernel: str, args, n_lights: int, eps_dist: float) -> int:
    """Operations one call of a shading kernel (`light_shade`,
    `shade_eval_rows`) needs on its inputs: per lit (ray, light) pair the
    shadow scan up to the first opaque occluder (spheres, then big
    triangles, then the Morton blocks whose box the shadow segment
    crosses), plus per-pair and per-ray shading. `args` are the call's
    positional arguments: light, sphere, big-triangle and block packs, block
    boxes, then point, normal, view, colour, shininess, valid."""
    light_pack, sph_pack, trb_pack, tri_blk_pack, tri_blk_aabb = args[:5]
    point, normal, valid = args[5], args[6], args[10] != 0
    P, N = point[valid], normal[valid]
    n_sph = int((sph_pack[:, 12] != 0).sum())
    ops = OPS_EPILOGUE[kernel] * int(valid.sum())
    packs = [(trb_pack, None)] + [(tri_blk_pack[b], tri_blk_aabb[b])
                                  for b in range(tri_blk_pack.shape[0])]
    for li in range(n_lights):
        lp = light_pack[li, 0:3]
        ltp = lp[None, :] - P
        lt = ltp.norm(dim=1)
        lit = (ltp * N).sum(1) / lt > 0
        ops += OPS_LIGHT * int(lit.sum())
        ld = ltp[lit] / lt[lit, None]
        so = P[lit] + ld * eps_dist
        maxd = (lp[None, :] - so).norm(dim=1)
        ops += OPS_SPHERE * n_sph * so.shape[0]
        st, sv = _sphere_ts(sph_pack[:, 0:3], sph_pack[:, 3], sph_pack[:, 12] != 0, so, ld)
        live = ~(sv & (st <= maxd[:, None]) & (sph_pack[None, :, 8] == 0)).any(1)
        for pack, box in packs:
            scan = live if box is None else live & gate_hits(box[None], so, ld, maxd)[:, 0]
            t, v = _woop_ts(pack, so, ld)
            stop = v & (t <= maxd[:, None]) & (pack[None, :, 14] == 0)
            n_rows = int((pack[:, 13] != 0).sum()) if box is None else pack.shape[0]
            rows = torch.where(stop.any(1), stop.float().argmax(1) + 1,
                               torch.full_like(maxd, n_rows, dtype=torch.long))
            ops += OPS_TRI * int(rows[scan].sum())
            live = live & ~(scan & stop.any(1))
    return ops


def roofline_pct(kernel: str, calls) -> float | None:
    """Share of the roofline over captured calls: the sum of each call's
    bound over the sum of its device time, in %. `calls` are dicts with
    `args`, `kw`, `out` and `device_s` (None when the trace lacks it)."""
    calls = [c for c in calls if c.get("device_s")]
    if not calls:
        return None
    bound = sum(bound_s(nbytes(*c["args"], *c["out"]),
                        shade_ops(kernel, c["args"], c["kw"]["n_lights"], c["kw"]["eps_dist"]))
                for c in calls)
    return 100.0 * bound / sum(c["device_s"] for c in calls)
