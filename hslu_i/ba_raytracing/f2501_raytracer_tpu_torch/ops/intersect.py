"""Batched ray casting and occlusion testing.

The port's counterpart of the JAX package's `ops/intersect.py`: rays are
dense wavefronts (R, 3); triangles are tested block-at-a-time against
precomputed Woop transforms (scene/device.py); nearest-hit selection is a
running (t, index) min (ref raytracing/raytracer.rs:162-220 `cast_ray`,
:24-106 `has_any_intersection`).

`cast_rays` and `occlude_rays` send the triangle scan through the kernels of
`ops/kernels.py` (a CUDA kernel on a CUDA tensor, the plain twin built from
the functions of this module on a CPU tensor): `cast_triangles` /
`occlude_triangles` for a resident scene, `cast_triangles_stream` /
`occlude_triangles_stream` for a scene past `cfg.stream_triangles`
(`scene.streaming`), where the big-primitive pack is scanned in plain
PyTorch beside the spheres. The sphere tests and the material row gather
are plain PyTorch on every path. `occlude_packs` is plain PyTorch only: it
backs the twin of the fused light kernels (`ops/shading.py::light_sums`).

Semantics preserved exactly (these define the image):
* sphere root selection prefers the nearest non-negative t (sphere.rs:108-129)
* triangle validity: t > eps, u,v >= 0, u+v < 1, |det| > eps (triangle.rs:188-198)
* runtime backface cull quirk: dot(dir, normal) < 0.75 OR transmissive
  (sphere.rs:137-151, triangle.rs:154-168)
* shadow accumulation: multiplicative opacity through transmissive occluders
  with Fresnel transmittance, subtractive color filter, opaque hit =>
  completely occluded (raytracer.rs:43-98)
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.device import DeviceScene
from .vecmath import F32_EPSILON, normalized

INF = float("inf")
# "no hit" index of the triangle scan (the Pallas kernel's BIG_IDX)
BIG_IDX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Hit:
    """Wavefront surface-interaction record (ref surface_interaction.rs:13-32),
    with the material already gathered from the object SoA."""

    valid: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    point: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3) shading normal (non-unit for OBJ triangles)
    obj_idx: torch.Tensor  # (R,) int64 global object index
    color: torch.Tensor  # (R, 3)
    metallic: torch.Tensor  # (R,)
    shininess: torch.Tensor  # (R,)
    ior: torch.Tensor  # (R,)
    opacity: torch.Tensor  # (R,) transmission opacity value (0 where unset)
    has_trans: torch.Tensor  # (R,) bool
    boost: torch.Tensor  # (R,)


def pow2(x):
    return x * x


def pow5(x):
    """x**5 in the order XLA expands an integer power (binary
    exponentiation: x * ((x*x) * (x*x))); the CUDA kernels use the same
    order, so the twins and the kernels round alike."""
    x2 = x * x
    return x * (x2 * x2)


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _sphere_ts(center, r_sq, sph_valid, o, d):
    """Quadratic per (ray, sphere): t (R,S) with the reference's root
    preference (sphere.rs:80-129) and validity ignoring backface culling."""
    oc = o[:, None, :] - center[None, :, :]  # (R,S,3)
    p = d[:, None, :] * oc
    b = 2.0 * ((p[..., 0] + p[..., 1]) + p[..., 2])
    q = oc * oc
    c = ((q[..., 0] + q[..., 1]) + q[..., 2]) - r_sq[None, :]
    disc = b * b - 4.0 * c
    disc_pos = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t0_valid = (t0 >= 0.0) & disc_pos
    t1_valid = (t1 >= 0.0) & disc_pos
    use_t0 = t0_valid & (~t1_valid | (t0 < t1))
    use_t1 = t1_valid & ~use_t0
    inf = torch.full_like(t0, INF)
    t = torch.where(use_t0, t0, torch.where(use_t1, t1, inf))
    valid = (use_t0 | use_t1) & sph_valid[None, :]
    return t, valid


def _sphere_cos(center, o, d, t):
    """cos between ray dir and outward unit normal at the hit point, (R,S)."""
    p = o[:, None, :] + d[:, None, :] * t[..., None]
    n = normalized(p - center[None, :, :])
    q = d[:, None, :] * n
    return (q[..., 0] + q[..., 1]) + q[..., 2]


def _tri_block_ts(woop, nsq, tvalid_f, o4, d):
    """One triangle block: t (R,B) (+inf invalid), validity (no backface).
    woop: (12, B) coefficient planes, plane 3k+c = coefficient of input
    component k for output coordinate c (rows 9-11: the translation)."""
    B = nsq.shape[0]
    w = woop.reshape(4, 3, B)

    def transform(vec, rows):
        comps = []
        for c in range(3):
            acc = vec[:, 0:1] * rows[0, c][None, :]
            for k in range(1, vec.shape[1]):
                acc = acc + vec[:, k : k + 1] * rows[k, c][None, :]
            comps.append(acc)
        return comps

    u_o, v_o, w_o = transform(o4, w)
    u_d, v_d, w_d = transform(d, w[:3])

    t = -w_o / w_d
    u = u_o + t * u_d
    v = v_o + t * v_d
    det = w_d * nsq[None, :]  # = d·ñ = det([d,-e1,-e2])  (triangle.rs:179)
    valid = (
        (t > F32_EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v < 1.0)
        & (torch.abs(det) > F32_EPSILON)
        & (tvalid_f[None, :] != 0.0)
    )
    return torch.where(valid, t, torch.full_like(t, INF)), valid


def _dot3_planes(d, tn3):
    """(R,3)x(3,B) -> (R,B), left to right."""
    return (
        d[:, 0:1] * tn3[0][None, :]
        + d[:, 1:2] * tn3[1][None, :]
        + d[:, 2:3] * tn3[2][None, :]
    )


def _backface_mask(cos_dn, has_trans):
    """ref sphere.rs:137-151 / triangle.rs:154-168: visible when
    dot(dir, normal) < 0.75 or the material is transmissive."""
    return (cos_dn < 0.75) | has_trans


def _homogeneous(o):
    return torch.cat([o, torch.ones_like(o[:, :1])], dim=1)


def _sphere_nearest(scene, o, d, backface_culling):
    S = scene.sphere_slots
    return _sphere_nearest_of(scene.sph_center, scene.sph_r_sq, scene.sph_valid,
                              scene.mat_has_trans[:S], o, d, backface_culling)


def _sphere_nearest_of(center, r_sq, sph_valid, has_trans, o, d, backface_culling):
    """Nearest sphere of each ray over the (S,) sphere slots: (t, slot),
    +inf and the first slot where none is hit; argmin keeps the first slot
    on equal t."""
    st, s_valid = _sphere_ts(center, r_sq, sph_valid, o, d)
    if backface_culling:
        cos = _sphere_cos(center, o, d, _where0(s_valid, st))
        s_valid = s_valid & _backface_mask(cos, has_trans[None, :])
    st = torch.where(s_valid, st, torch.full_like(st, INF))
    return torch.min(st, dim=1).values, torch.argmin(st, dim=1)


def _pack_nearest(pack, o4, d, backface_culling):
    """Nearest hit over one (n, 32) triangle pack -- the big-primitive pack
    or one Morton block of `tri_cast_pack` (lanes 0-11 Woop, 12 |ñ|²,
    13 valid, 14 transmissive, 15-17 shading normal). The plain path of
    the JAX package's `_bigtri_nearest_xla` / `_tri_nearest_xla` block
    body: t (R,), local row (R,); argmin keeps the lowest row on equal t."""
    t, valid = _tri_block_ts(pack[:, 0:12].T, pack[:, 12], pack[:, 13], o4, d)
    if backface_culling:
        cos_dn = _dot3_planes(d, pack[:, 15:18].T)
        valid = valid & _backface_mask(cos_dn, pack[None, :, 14] != 0.0)
    t = torch.where(valid, t, torch.full_like(t, INF))
    return torch.min(t, dim=1).values, torch.argmin(t, dim=1)


def cast_rays(scene: DeviceScene, o, d, backface_culling: bool = False) -> Hit:
    """Nearest-hit cast of R rays (ref raytracer.rs:162-220). `d` must be
    normalized (Ray::new normalizes, ray.rs:54)."""
    from .kernels import cast_triangles, cast_triangles_stream

    S = scene.sphere_slots
    best_t, best_idx = _sphere_nearest(scene, o, d, backface_culling)

    if scene.streaming:
        # big primitives in plain ops, then the streamed Morton-block scan,
        # which returns local slots (JAX intersect.py:253-280)
        bt, bidx = _pack_nearest(scene.trb_pack, _homogeneous(o), d, backface_culling)
        closer = bt < best_t
        best_t = torch.where(closer, bt, best_t)
        best_idx = torch.where(closer, S + bidx, best_idx)
        tt, tidx = cast_triangles_stream(
            scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb, o, d,
            backface_culling=backface_culling, sb_sizes=scene.sb_sizes,
        )
        tri_base = S + scene.n_bigtris
    else:
        # triangle scan in the kernel's local index space: big primitive
        # p -> p, Morton slot s -> P_pad + s (JAX intersect.py:281-300)
        tt, tidx = cast_triangles(
            scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb,
            o, d, backface_culling=backface_culling, sb_sizes=scene.sb_sizes,
        )
        tri_base = S
    return _hit_record(scene.mat_pack, S, o, d, best_t, best_idx, tt, tidx, tri_base)


def _hit_record(mat_pack, S, o, d, best_t, best_idx, tt, tidx, tri_base) -> Hit:
    """The cast's epilogue: the triangle scan's nearest hit (tt, tidx at
    index tri_base + tidx) folded into the nearest (best_t, best_idx) so far
    with a strict `<`, the hit point, one packed material row gather
    (`mat_pack`, its first S rows the sphere slots) and the normal."""
    closer = tt < best_t
    best_t = torch.where(closer, tt, best_t)
    best_idx = torch.where(closer, tri_base + tidx.long(), best_idx)

    valid = torch.isfinite(best_t)
    t_safe = _where0(valid, best_t)
    point = o + d * t_safe[:, None]

    # ONE packed (R, 16) row gather for every material field + the normal
    # auxiliary (sphere center / triangle shading normal)
    row = mat_pack.index_select(0, best_idx)
    is_sphere = best_idx < S
    aux = row[:, 9:12]
    sph_normal = normalized(point - aux)
    normal = torch.where(is_sphere[:, None], sph_normal, aux)

    return Hit(
        valid=valid,
        t=best_t,
        point=point,
        normal=normal,
        obj_idx=best_idx,
        color=row[:, 0:3],
        metallic=row[:, 3],
        shininess=row[:, 4],
        ior=row[:, 5],
        opacity=row[:, 6],
        has_trans=row[:, 7] != 0.0,
        boost=row[:, 8],
    )


def _shadow_transmittance_red(cos_nv, ior, opacity, metallic, color_r, has_trans):
    """Red channel of (1 - F) for a shadow ray through a transmissive occluder
    (ref material.rs:467-525 with other_ior = 1, view = -shadow_dir;
    raytracer.rs:57-74). transmittance.red == .green == .blue per the
    reference's own comment."""
    n_dot_v = cos_nv
    cos_theta = torch.abs(n_dot_v)
    is_inside = n_dot_v < 0.0
    eta_t = torch.where(is_inside, ior, 1.0 / ior)
    sin2_t = eta_t * eta_t * (1.0 - cos_theta * cos_theta)
    is_reflective = metallic > 0.0
    is_tir = (has_trans & is_inside & (sin2_t > 1.0)) | is_reflective
    f0 = pow2((1.0 - ior) / (1.0 + ior))
    f0r = f0 + (color_r - f0) * metallic
    fresnel_r = f0r + (1.0 - f0r) * pow5(1.0 - cos_theta)
    reflected_amount_r = torch.where(is_reflective, metallic, torch.ones_like(metallic))
    f_r = torch.where(is_tir, reflected_amount_r, fresnel_r)
    # lanes whose material is NOT transmissive take the early-exit branch
    # (F = metallic); callers zero those out anyway (raytracer.rs:63-67).
    f_r = torch.where(has_trans, f_r, metallic)
    return 1.0 - f_r


def _sphere_occlusion(sph_pack, o, d, max_distance, backface_culling):
    """Shadow accumulators over the sphere pack (S_pad, 16):
    [cx,cy,cz,rsq,ior,op,met,colr,httr,absr,absg,absb,valid,0,0,0]."""
    center = sph_pack[:, 0:3]
    st, s_valid = _sphere_ts(center, sph_pack[:, 3], sph_pack[:, 12] != 0.0, o, d)
    httr = sph_pack[None, :, 8] != 0.0
    cos = _sphere_cos(center, o, d, _where0(s_valid, st))
    if backface_culling:
        s_valid = s_valid & _backface_mask(cos, httr)
    s_hit = s_valid & (st <= max_distance[:, None])
    t_red = _shadow_transmittance_red(
        -cos,  # fresnel is called with view = -ray.direction (raytracer.rs:57-60)
        sph_pack[None, :, 4], sph_pack[None, :, 5], sph_pack[None, :, 6],
        sph_pack[None, :, 7], httr,
    )
    t_red = _where0(httr, t_red)
    io = _where0(httr, sph_pack[None, :, 5]) * t_red
    dec = torch.sum(_where0(s_hit, 1.0 - io), dim=1)
    opq = torch.any(s_hit & ~httr, dim=1)
    fsub = s_hit.to(o.dtype) @ sph_pack[:, 9:12]
    return dec, opq, fsub


def _pack_occlusion(pack, o4, d, max_distance, backface_culling):
    """Shadow accumulators over one (n, 32) triangle pack (the big-primitive
    pack or one Morton block of `tri_blk_pack`; lanes 18 ior, 19 opacity,
    20 metallic, 21 color.r, 22-24 absorption besides the cast lanes): the
    plain path of the JAX package's `_bigtri_occlusion_xla` and of one
    `_tri_occlusion_xla` block."""
    t, valid = _tri_block_ts(pack[:, 0:12].T, pack[:, 12], pack[:, 13], o4, d)
    httr = pack[None, :, 14] != 0.0
    cos_nv = -_dot3_planes(d, pack[:, 15:18].T)
    if backface_culling:
        valid = valid & _backface_mask(-cos_nv, httr)
    hit = valid & (t <= max_distance[:, None])
    tr = _shadow_transmittance_red(
        cos_nv, pack[None, :, 18], pack[None, :, 19], pack[None, :, 20],
        pack[None, :, 21], httr,
    )
    tr = _where0(httr, tr)
    io = _where0(httr, pack[None, :, 19]) * tr
    dec = torch.sum(_where0(hit, 1.0 - io), dim=1)
    opq = torch.any(hit & ~httr, dim=1)
    fsub = hit.to(o4.dtype) @ pack[:, 22:25]
    return dec, opq, fsub


def _add_pack_occlusion(sums, packs, o, d, max_distance, backface_culling):
    """Add one `_pack_occlusion` result per pack, in order, to the running
    (dec, opq, fsub)."""
    dec, opq, fsub = sums
    o4 = _homogeneous(o)
    for pack in packs:
        pdec, popq, pfsub = _pack_occlusion(pack, o4, d, max_distance, backface_culling)
        dec = dec + pdec
        opq = opq | popq
        fsub = fsub + pfsub
    return dec, opq, fsub


def occlude_packs(sph_pack, trb_pack, tri_blk_pack, o, d, max_distance,
                  backface_culling: bool = False):
    """Shadow/occlusion test (ref raytracer.rs:24-106), plain PyTorch, over
    the kernel-packed scene tables: spheres, big primitives, then the Morton
    blocks in `tri_blk_pack` order (the order the fused light kernels scan
    them in). The twin of those kernels' shadow scan; returns what
    `occlude_rays` returns."""
    sums = _sphere_occlusion(sph_pack, o, d, max_distance, backface_culling)
    return _occlusion_result(*_add_pack_occlusion(
        sums, [trb_pack, *tri_blk_pack], o, d, max_distance, backface_culling))


def _occlusion_result(dec, opq, fsub):
    combined_opacity = torch.clamp(1.0 - dec, 0.0, 1.0)
    color_filter = 1.0 - fsub
    return opq, combined_opacity, color_filter


def occlude_rays(scene: DeviceScene, o, d, max_distance, backface_culling: bool = False):
    """Shadow/occlusion test of R rays against the scene (ref
    raytracer.rs:24-106; JAX `occlude_rays`): spheres in plain PyTorch, the
    triangles through the `occlude_triangles` kernel, or -- for a streamed
    scene -- big primitives in plain PyTorch and the Morton blocks through
    `occlude_triangles_stream`.

    Returns (completely_occluded (R,), combined_opacity (R,), color_filter (R,3)).
    completely_occluded reduces to "any opaque valid hit within distance";
    combined_opacity = max(0, 1 - sum(1 - opacity_i * T_i)) over occluders;
    color_filter = 1 - sum(absorption_i) over occluders (can go negative, as
    in the reference). The backface-cull quirk applies to shadow rays too.
    completely_occluded is exact; the other two are specified where it is
    False (a kernel's scan stops at the first opaque hit, and the lighting
    reads them only for a light that reaches the point)."""
    from .kernels import occlude_triangles, occlude_triangles_stream

    dec, opq, fsub = _sphere_occlusion(scene.sph_pack, o, d, max_distance, backface_culling)
    if scene.streaming:
        dec, opq, fsub = _add_pack_occlusion(
            (dec, opq, fsub), [scene.trb_pack], o, d, max_distance, backface_culling)
        tdec, topq, tfsub = occlude_triangles_stream(
            scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb, o, d, max_distance,
            backface_culling=backface_culling, block_has_trans=scene.block_has_trans,
            sb_sizes=scene.sb_sizes,
        )
    else:
        tdec, topq, tfsub = occlude_triangles(
            scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb,
            o, d, max_distance, backface_culling=backface_culling,
            bigtri_trans=scene.bigtri_trans, block_has_trans=scene.block_has_trans,
            sb_sizes=scene.sb_sizes,
        )
    return _occlusion_result(dec + tdec, opq | topq, fsub + tfsub)
