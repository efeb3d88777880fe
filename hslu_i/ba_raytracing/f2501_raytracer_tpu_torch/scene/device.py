"""Device scene: SoA scene tensors on the device + triangle precompute.

The numpy build below is the JAX package's, line for line, so both
packages produce the same arrays from the same scene (the port's tests
hold every field equal); only the last step differs: the arrays become
torch tensors on the requested device. `device_scene_from_arrays` turns
arrays made elsewhere (for example the JAX scene's, as numpy) into the
port's `DeviceScene`.

This replaces the reference's `GeometryCollection` + per-ray `splat`
machinery (ref render_geometry.rs:99-155, helpers.rs Splatable): instead of
broadcasting one object across 8 SIMD lanes, every object lives in a dense
array and whole wavefronts of rays are tested against object blocks at once.

Triangles are stored as Woop unit-triangle transforms: for triangle
(v1, e1, e2) with geometric normal ñ = e1×e2, A = inv([e1 e2 ñ]) and
b = -A·v1 map a world point p to barycentric coordinates (u, v, w) with w the
ñ-scaled offset from the plane. A ray (o, d) then intersects at
t = -w_o / w_d,  u = u_o + t·u_d,  v = v_o + t·v_d — and (u,v,w)_o / (u,v,w)_d
for *all* triangles are two matmuls `[o|1] @ W4` / `d @ W3`, which run on the
MXU instead of the VPU. The t/u/v math is identical to the reference's
Cramer 3×3 solve (ref triangle.rs:170-198) up to f32 rounding, and the
reference's determinant test |det([d,-e1,-e2])| = |d·ñ| = |w_d·ñ·ñ| is
recovered from w_d and the precomputed |ñ|².
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..config import RenderConfig
from ..materials import Material
from .builder import Scene, SphereData, TriangleData
from ..utils.devices import resolve_device
from .lighting import preprocess_lights


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Z-order permutation of triangle centroids (native lib or numpy).
    Spatially-local triangles land in the same 128/256-triangle block, which
    makes per-block AABBs tight — the basis for cluster culling."""
    from ..utils.native import native_morton_order

    order = native_morton_order(centroids)
    if order is not None:
        return order.astype(np.int64)

    lo = centroids.min(axis=0)
    rng = np.maximum(centroids.max(axis=0) - lo, 1e-30)
    q = ((centroids - lo) / rng * 1023.0).astype(np.uint64)

    def expand(v):
        v &= 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    code = expand(q[:, 0]) | (expand(q[:, 1]) << 1) | (expand(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def compute_woop_transforms(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray):
    """Batch Woop transforms for T triangles: (T,4,3) [A^T | b], |ñ|^2 (T,),
    valid (T,). Uses the native host library when available, else vectorized
    numpy (batched 3x3 inverse)."""
    from ..utils.native import native_woop_transforms

    out = native_woop_transforms(v1, v2, v3)
    if out is not None:
        return out

    T = v1.shape[0]
    e1, e2 = v2 - v1, v3 - v1
    ng = np.cross(e1, e2)
    n2 = np.einsum("tc,tc->t", ng, ng)
    ok = np.isfinite(n2) & (n2 > 0.0)
    M = np.stack([e1, e2, ng], axis=2)  # (T,3,3) columns
    M_safe = np.where(ok[:, None, None], M, np.eye(3)[None])
    A = np.linalg.inv(M_safe)  # (T,3,3)
    b = -np.einsum("tij,tj->ti", A, v1)
    w4 = np.concatenate([A.transpose(0, 2, 1), b[:, None, :]], axis=1)  # (T,4,3)
    return w4.astype(np.float32), n2.astype(np.float32), ok


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """SoA scene arrays. Object index space: [0, S) spheres, [S, S+T) triangles."""

    # spheres
    sph_center: torch.Tensor  # (S, 3)
    sph_r_sq: torch.Tensor  # (S,)
    sph_valid: torch.Tensor  # (S,) bool

    # triangles, block-planar layout shared by the XLA scan and the Pallas
    # kernels: plane index 3k+c = coefficient of input component k for
    # output coordinate c (rows 0-8: A^T, rows 9-11: b)
    tri_woop: torch.Tensor  # (nb, 12, B)
    tri_nsq: torch.Tensor  # (nb, B) |ñ|^2
    tri_normal3: torch.Tensor  # (nb, 3, B) shading normal planes (may be non-unit)
    tri_valid_f: torch.Tensor  # (nb, B) 1.0/0.0
    tri_httr_f: torch.Tensor  # (nb, B) transmission mask as 1.0/0.0
    tri_ior: torch.Tensor  # (nb, B)
    tri_op: torch.Tensor  # (nb, B) opacity value
    tri_met: torch.Tensor  # (nb, B) metallic
    tri_colr: torch.Tensor  # (nb, B) color red channel (shadow fresnel)
    tri_absn: torch.Tensor  # (nb, 3, B) absorption planes
    tri_aabb: torch.Tensor  # (nb, 8) per-block AABB: min xyz, max xyz, pad
    # two-level culling: superblock AABBs unioning `sb_sizes` consecutive
    # blocks each — one slab test in the kernels skips a whole group
    tri_saabb: torch.Tensor  # (n_superblocks, 8)

    # per-object materials, global index space (S + nb*B entries)
    mat_color: torch.Tensor  # (N, 3)
    mat_metallic: torch.Tensor  # (N,)
    mat_shininess: torch.Tensor  # (N,)
    mat_ior: torch.Tensor  # (N,)
    mat_opacity: torch.Tensor  # (N,) value (0 where unset)
    mat_has_trans: torch.Tensor  # (N,) bool — TransmissionProperties::mask()
    mat_boost: torch.Tensor  # (N,)
    mat_absorption: torch.Tensor  # (N, 3) — precomputed Material::absorption()
    obj_normal: torch.Tensor  # (N, 3) — triangle shading normal, zeros for spheres
    # packed per-object row table for the post-cast material gather: ONE
    # (R, 16) row gather replaces ~12 separate jnp.takes (TPU gathers cost
    # ~the same per row regardless of width; measured in PERF.md). Columns:
    # [color3 | metallic | shininess | ior | opacity | has_trans | boost |
    #  aux3 (sphere center / triangle shading normal) | pad4]
    mat_pack: torch.Tensor  # (N, 16)

    # flattened lights (soft-shadow cloud already expanded)
    light_pos: torch.Tensor  # (L, 3)
    light_color: torch.Tensor  # (L, 3)
    light_intensity: torch.Tensor  # (L,)
    # kernel-packed forms: lights (L_pad, 8) rows [pos3|color3|intensity|0];
    # spheres (S_pad, 16): one sphere per SUBLANE row, 16 property lanes
    # [cx,cy,cz,rsq,ior,op,met,colr,httr,absr,absg,absb,valid,0,0,0]
    light_pack: torch.Tensor
    sph_pack: torch.Tensor
    # rolled/flipped shadow-scan pack: (nb, B, 32) one Morton block per
    # leading index, triangles on sublanes, trb_pack lane map; blocks
    # reordered transmissive-first with its own AABB table (see
    # build_device_scene) — consumed by the rolled light-kernel block loop
    tri_blk_pack: torch.Tensor
    tri_blk_aabb: torch.Tensor  # (nb, 8), blk_pack block order
    # same pack in CAST order (front-to-back Morton blocks, slot indices
    # aligned with the planar arrays / mat_pack rows) for the rolled
    # nearest-hit scan; AABB table = tri_aabb
    tri_cast_pack: torch.Tensor
    # big primitives (walls/floors): (P_pad, 32), one triangle per SUBLANE
    # row — lanes 0-11 woop, 12 |ñ|², 13 valid, 14 httr, 15-17 normal,
    # 18 ior, 19 opacity, 20 metallic, 21 color.r, 22-24 absorption; object
    # index range [S_pad, S_pad + P_pad). See the slot-layout comment in
    # build_device_scene.
    trb_pack: torch.Tensor

    # static metadata
    n_lights: int
    # leading blocks of tri_blk_pack containing transmissive triangles
    n_trans_blocks: int
    n_spheres: int
    n_triangles: int
    tri_block: int
    # big-primitive pack: slot count and whether any is transmissive (static:
    # all-opaque packs skip the shadow-Fresnel math in the kernels)
    n_bigtris: int = 8
    bigtri_trans: bool = True
    # leading sublane rows of trb_pack holding transmissive bigtris (rounded
    # up to 8): the light kernel's Fresnel runs only on these rows
    bigtri_trans_rows: int = 8
    # which blocks contain transmissive materials (static: lets the shadow
    # kernel skip the Fresnel math on all-opaque blocks)
    block_has_trans: tuple = ()
    # scene exceeds the VMEM-residency budget: cast/occlude use the
    # HBM-streaming kernels and lighting routes through the occlusion path
    streaming: bool = False
    # superblock partition (static): sizes of consecutive block groups under
    # each tri_saabb row; sums to the block count
    sb_sizes: tuple = ()

    @property
    def sphere_slots(self) -> int:
        return self.sph_center.shape[0]

    @property
    def triangle_blocks(self) -> int:
        return self.tri_woop.shape[0]


# DeviceScene fields that are tensors (the rest are static metadata)
ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(DeviceScene) if f.type == "torch.Tensor"
)
STATIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(DeviceScene) if f.name not in ARRAY_FIELDS
)


def device_scene_from_arrays(fields: dict, static: dict, device=None) -> DeviceScene:
    """Build the port's DeviceScene from numpy arrays (one per tensor field)
    and the static metadata (ints, bools, tuples). This is how a scene built
    elsewhere -- e.g. the JAX package's DeviceScene, passed as numpy -- is
    carried into the port unchanged."""
    dev = resolve_device(device)
    missing = set(ARRAY_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing DeviceScene arrays: {sorted(missing)}")
    # np.array copies: the tensors never alias (possibly read-only) inputs
    tensors = {k: torch.from_numpy(np.array(fields[k])).to(dev) for k in ARRAY_FIELDS}
    meta = {k: (tuple(static[k]) if isinstance(static[k], (list, tuple))
                else static[k]) for k in STATIC_FIELDS}
    return DeviceScene(**tensors, **meta)


SUPERBLOCK = 8  # default Morton blocks per superblock AABB (two-level culling)
# big primitives beyond this count overflow back into the Morton blocks
# (the sublane pack's pair math is unconditional, so it must stay small)
BIGTRI_CAP = 128


def _resolve_block(cfg: RenderConfig) -> int:
    """triangle_block=0 -> auto by measured regime (see config.py comment
    and PERF.md "Extreme-config light-kernel decomposition"/block sweeps):
    hq-mesh scenes 256; plain scenes 64 at >=1e6-pixel frames, else 512.
    The hq predicate is cfg.uses_hq_mesh — the same rule that picks the
    OBJ file (models/semesterbild.py), so a default-resolution (1140x950)
    scene that loads the hq mesh also gets the hq-measured block size."""
    if cfg.triangle_block:
        return cfg.triangle_block
    if cfg.uses_hq_mesh:
        return 256
    return 64 if cfg.width * cfg.height >= 10**6 else 512


def build_device_scene(scene: Scene, cfg: RenderConfig, min_tri_blocks: int = 1,
                       device=None) -> DeviceScene:
    """Build the scene's arrays on the host and move them to `device`
    (default: the card). `min_tri_blocks` pads the triangle-block count up
    to a multiple (kept from the JAX build, which uses it to shard blocks
    across a device mesh)."""
    fields, static = build_scene_arrays(scene, cfg, min_tri_blocks)
    return device_scene_from_arrays(fields, static, device)


def build_scene_arrays(scene: Scene, cfg: RenderConfig, min_tri_blocks: int = 1):
    """The numpy build: (fields {name: ndarray}, static {name: value})."""
    spheres: List[SphereData] = scene.scene_objects.spheres
    triangles: List[TriangleData] = scene.scene_objects.triangles
    S, T = len(spheres), len(triangles)

    S_pad = max(_round_up(S, 8), 8)
    B = min(_resolve_block(cfg), max(_round_up(T, 128), 128))

    # ---- triangle slot layout --------------------------------------------
    # Large primitives (walls/floors) leave the Morton blocks entirely:
    # mixing one wall into a Morton cell blows that block's AABB up to room
    # size and defeats culling for the whole cell — and a room-sized AABB is
    # never culled anyway, so a handful of walls would otherwise pin a full
    # B-lane block of pair math on every ray. They go into a SUBLANE pack
    # instead (trb_pack, like sph_pack): up to BIGTRI_CAP triangles on the
    # sublane axis with their 25 property planes on lanes, so S big
    # primitives cost ceil(S/8) sublane rows per VPU op instead of B lanes.
    # The rest is Morton-ordered so each block is spatially tight — the
    # basis for per-ray cluster culling.
    if T:
        cent = np.stack([t.get_center() for t in triangles]).astype(np.float32)
        v1s = np.stack([t.vertex1 for t in triangles]).astype(np.float64)
        v2s = np.stack([t.vertex2 for t in triangles]).astype(np.float64)
        v3s = np.stack([t.vertex3 for t in triangles]).astype(np.float64)
        tri_lo = np.minimum(np.minimum(v1s, v2s), v3s).astype(np.float32)
        tri_hi = np.maximum(np.maximum(v1s, v2s), v3s).astype(np.float32)
        diag = np.linalg.norm(tri_hi - tri_lo, axis=1)
        scene_diag = float(np.linalg.norm(tri_hi.max(0) - tri_lo.min(0))) or 1.0
        big = diag > 0.1 * scene_diag
        big_idx = np.where(big)[0].astype(np.int64)
        if len(big_idx) > BIGTRI_CAP:  # overflow back to the Morton blocks
            by_diag = big_idx[np.argsort(-diag[big_idx], kind="stable")]
            big_idx = np.sort(by_diag[:BIGTRI_CAP])
            big = np.zeros_like(big)
            big[big_idx] = True
        # transmissive rows first: the light kernel runs the shadow-Fresnel
        # math only on the leading bigtri_trans_rows sublane rows
        if len(big_idx):
            btr = np.array(
                [triangles[i].material.transmission.mask for i in big_idx], bool
            )
            big_idx = np.concatenate([big_idx[btr], big_idx[~btr]])
            n_big_trans = int(btr.sum())
        else:
            n_big_trans = 0
        small_idx = np.where(~big)[0]
        small_order = (
            small_idx[morton_order(cent[small_idx])] if len(small_idx) else small_idx
        ).astype(np.int64)
    else:
        big_idx = small_order = np.zeros((0,), np.int64)
        n_big_trans = 0

    P_pad = max(_round_up(len(big_idx), 8), 8)
    T_pad = max(_round_up(max(len(small_order), 1), B), B)
    nb = _round_up(T_pad // B, min_tri_blocks)
    T_pad = nb * B
    N = S_pad + P_pad + T_pad

    slot_tri = np.full((T_pad,), -1, np.int64)  # -1 = padding slot
    slot_tri[: len(small_order)] = small_order

    # ---- superblock partition over Morton blocks --------------------------
    # trailing empty blocks sit in singleton groups (an inverted AABB must
    # not poison a Morton superblock); Morton blocks group in runs of
    # SUPERBLOCK, which stay spatially tight because consecutive Morton
    # blocks are neighbours in space.
    sb = int(getattr(cfg, "superblock", 0)) or SUPERBLOCK
    nb_small = -(-len(small_order) // B) if len(small_order) else 0
    sb_sizes = []
    for s in range(0, nb_small, sb):
        sb_sizes.append(min(sb, nb_small - s))
    sb_sizes += [1] * (nb - nb_small)

    # ---- per-block AABBs (real triangles only) ----------------------------
    blocks = slot_tri.reshape(nb, B)
    block_lo = np.full((nb, 3), 1e8, np.float32)  # empty: inverted, never hit
    block_hi = np.full((nb, 3), -1e8, np.float32)
    for b in range(nb):
        sel = blocks[b][blocks[b] >= 0]
        if len(sel):
            block_lo[b] = tri_lo[sel].min(axis=0)
            block_hi[b] = tri_hi[sel].max(axis=0)

    # ---- front-to-back ordering at GROUP granularity ----------------------
    # The cast kernels walk blocks in storage order carrying a running-min t;
    # near-camera blocks first shrink the per-ray t-limit early. Sorting
    # whole groups (and blocks within a group) keeps superblocks tight while
    # approximating a global front-to-back walk. Order never changes results
    # (the running min is exact; shadow accumulation is order-free).
    focus = np.asarray(cfg.camera.render_ray_focus, np.float32)
    bdist = np.where(
        (block_lo <= block_hi).all(axis=1),
        np.linalg.norm(np.clip(focus, block_lo, block_hi) - focus, axis=1),
        np.inf,
    )
    groups, s = [], 0
    for n in sb_sizes:
        groups.append(list(range(s, s + n)))
        s += n
    groups.sort(key=lambda g: min(bdist[b] for b in g))
    order_blocks, sb_sizes = [], []
    for g in groups:
        order_blocks.extend(sorted(g, key=lambda b: bdist[b]))
        sb_sizes.append(len(g))
    slot_tri = blocks[order_blocks].reshape(-1)
    block_lo, block_hi = block_lo[order_blocks], block_hi[order_blocks]

    aabb = np.zeros((nb, 8), np.float32)
    aabb[:, 0:3] = block_lo
    aabb[:, 3:6] = block_hi
    nsb = len(sb_sizes)
    saabb = np.zeros((nsb, 8), np.float32)
    s = 0
    for gi, n in enumerate(sb_sizes):
        saabb[gi, 0:3] = block_lo[s : s + n].min(axis=0)
        saabb[gi, 3:6] = block_hi[s : s + n].max(axis=0)
        s += n

    sph_center = np.zeros((S_pad, 3), np.float32)
    sph_r_sq = np.ones((S_pad,), np.float32)
    sph_valid = np.zeros((S_pad,), bool)
    for i, sph in enumerate(spheres):
        sph_center[i] = sph.center
        sph_r_sq[i] = sph.r_sq
        sph_valid[i] = True
    # park padded spheres far away so even unmasked math stays finite
    sph_center[S:] = 1e8

    woop4 = np.zeros((T_pad, 4, 3), np.float32)
    nsq = np.ones((T_pad,), np.float32)
    tnormal = np.zeros((T_pad, 3), np.float32)
    tvalid = np.zeros((T_pad,), bool)
    # padded slots: identity transform far away -> t large, masked anyway
    woop4[:, 0, 0] = 1.0
    woop4[:, 1, 1] = 1.0
    woop4[:, 2, 2] = 1.0
    woop4[:, 3, :] = (0.0, 0.0, 1e8)

    real_slots = np.where(slot_tri >= 0)[0]
    tri_sel = slot_tri[real_slots]
    if T:
        w4, n2, ok = compute_woop_transforms(v1s[tri_sel], v2s[tri_sel], v3s[tri_sel])
        ok_slots = real_slots[ok]
        woop4[ok_slots] = w4[ok]
        nsq[ok_slots] = n2[ok]
        norms = np.stack([t.normal for t in triangles]).astype(np.float32)
        tnormal[real_slots] = norms[tri_sel]
        tvalid[real_slots] = ok

    # ---- big-primitive sublane pack ---------------------------------------
    # (P_pad, 32): one big triangle per SUBLANE row, its 25 property planes
    # on lanes — lanes 0-11 woop coefficients (3k+c convention, 9-11 = b),
    # 12 |ñ|², 13 valid, 14 httr, 15-17 shading normal, 18 ior, 19 opacity,
    # 20 metallic, 21 color red, 22-24 absorption. P big primitives then
    # cost ceil(P/8) sublane rows per VPU op in the pair kernels instead of
    # a full B-lane block that a room-sized AABB can never cull.
    trb_pack = np.zeros((P_pad, 32), np.float32)
    trb_pack[:, 18] = 1.0  # padding ior 1.0 keeps fresnel math finite
    if len(big_idx):
        bw4, bn2, bok = compute_woop_transforms(
            v1s[big_idx], v2s[big_idx], v3s[big_idx]
        )
        P = len(big_idx)
        # (P,4,3) [A^T|b] -> lane 3k+c
        trb_pack[:P, 0:12] = bw4.reshape(P, 12)
        trb_pack[:P, 12] = bn2
        trb_pack[:P, 13] = bok.astype(np.float32)
        bnorms = np.stack([triangles[i].normal for i in big_idx]).astype(np.float32)
        trb_pack[:P, 15:18] = bnorms

    mat_color = np.zeros((N, 3), np.float32)
    mat_metallic = np.zeros((N,), np.float32)
    mat_shininess = np.zeros((N,), np.float32)
    mat_ior = np.ones((N,), np.float32)
    mat_opacity = np.zeros((N,), np.float32)
    mat_has_trans = np.zeros((N,), bool)
    mat_boost = np.zeros((N,), np.float32)
    mat_absorption = np.zeros((N, 3), np.float32)
    obj_normal = np.zeros((N, 3), np.float32)

    def fill_mat(idx: int, m: Material):
        mat_color[idx] = m.color
        mat_metallic[idx] = m.metallic
        mat_shininess[idx] = m.shininess
        mat_ior[idx] = m.transmission.refraction_index
        mat_opacity[idx] = m.transmission.opacity if m.transmission.opacity is not None else 0.0
        mat_has_trans[idx] = m.transmission.mask
        mat_boost[idx] = m.transmission.boost
        mat_absorption[idx] = m.absorption()

    for i, sph in enumerate(spheres):
        fill_mat(i, sph.material)
    # big-primitive object range: [S_pad, S_pad + P_pad)
    for p, ti in enumerate(big_idx):
        t = triangles[ti]
        fill_mat(S_pad + p, t.material)
        obj_normal[S_pad + p] = t.normal
        trb_pack[p, 14] = float(t.material.transmission.mask)
        trb_pack[p, 18] = t.material.transmission.refraction_index
        trb_pack[p, 19] = (
            t.material.transmission.opacity
            if t.material.transmission.opacity is not None
            else 0.0
        )
        trb_pack[p, 20] = t.material.metallic
        trb_pack[p, 21] = t.material.color[0]
        trb_pack[p, 22:25] = t.material.absorption()
    # Morton-block object range: [S_pad + P_pad, N)
    for slot, ti in zip(real_slots, tri_sel):
        t = triangles[ti]
        fill_mat(S_pad + P_pad + slot, t.material)
        obj_normal[S_pad + P_pad + slot] = t.normal

    def planar(x):  # (T_pad, ...) -> block-planar (nb, ..., B)
        if x.ndim == 1:
            return x.reshape(nb, B)
        return x.reshape(nb, B, x.shape[1]).transpose(0, 2, 1)

    tri_slice = slice(S_pad + P_pad, N)

    cam = cfg.camera
    lp, lc, li = preprocess_lights(
        scene.scene_lights, cfg.point_light_multiplicator, cam, seed=cfg.seed
    )
    # lights are consumed by a lax.scan — no padding needed (padded lights
    # would still pay a full occlusion scan each)
    L = max(lp.shape[0], 1)
    light_pos = np.zeros((L, 3), np.float32)
    light_color = np.zeros((L, 3), np.float32)
    light_intensity = np.zeros((L,), np.float32)
    light_pos[: lp.shape[0]] = lp
    light_color[: lp.shape[0]] = lc
    light_intensity[: lp.shape[0]] = li

    L_real = max(lp.shape[0], 1)
    L_pad = _round_up(L_real, 8)
    light_pack = np.zeros((L_pad, 8), np.float32)
    light_pack[:L_real, 0:3] = light_pos[:L_real]
    light_pack[:L_real, 3:6] = light_color[:L_real]
    light_pack[:L_real, 6] = light_intensity[:L_real]

    # sphere pack: SPHERES ON SUBLANES, 16 property lanes — a scene with S
    # spheres then costs ceil(S/8) sublane rows per VPU op instead of a full
    # 128-lane plane (9 semesterbild spheres: 2 rows, 16x less VPU work)
    sph_pack = np.zeros((S_pad, 16), np.float32)
    sph_pack[:, 0:3] = sph_center
    sph_pack[:, 3] = sph_r_sq
    sph_pack[:, 4] = mat_ior[:S_pad]  # 1.0 on padding: keeps fresnel finite
    sph_pack[:, 5] = mat_opacity[:S_pad]
    sph_pack[:, 6] = mat_metallic[:S_pad]
    sph_pack[:, 7] = mat_color[:S_pad, 0]
    sph_pack[:, 8] = mat_has_trans[:S_pad].astype(np.float32)
    sph_pack[:, 9:12] = mat_absorption[:S_pad]
    sph_pack[:, 12] = sph_valid.astype(np.float32)

    mat_pack = np.zeros((N, 16), np.float32)
    mat_pack[:, 0:3] = mat_color
    mat_pack[:, 3] = mat_metallic
    mat_pack[:, 4] = mat_shininess
    mat_pack[:, 5] = mat_ior
    mat_pack[:, 6] = mat_opacity
    mat_pack[:, 7] = mat_has_trans.astype(np.float32)
    mat_pack[:, 8] = mat_boost
    mat_pack[:, 9:12] = obj_normal
    mat_pack[:S_pad, 9:12] = sph_center  # sphere rows: center for the normal

    # ---- rolled/flipped shadow-scan pack ---------------------------------
    # (nb, B, 32): one Morton block per leading index, triangles on
    # SUBLANES, property planes on LANES (the trb_pack lane map). This is
    # the layout the rolled light-kernel block loop consumes: coefficient
    # columns (B, 1) broadcast against flat (RT,) rays into fully-filled
    # (B, RT) pair tiles (vs the planar (RT, B) form whose 64-lane tiles run
    # half-width), and ONE loop body serves every block (the 26x-unrolled
    # per-block code thrashed instruction memory — PERF.md round 3).
    # Blocks with any transmissive triangle are ordered FIRST so only the
    # leading n_trans_blocks blocks run the shadow-Fresnel body. Shadow
    # accumulation is semantically order-free (a sum/max over blocks), so
    # this pack may reorder blocks freely as long as it carries its own
    # AABB table — though the f32 sum ORDER changes with it; the cast
    # path's planar arrays and object indexing are untouched.
    httr_blk = mat_has_trans[tri_slice].reshape(nb, B)
    blk_pack = np.zeros((nb, B, 32), np.float32)
    blk_pack[:, :, 0:12] = woop4.reshape(nb, B, 12)
    blk_pack[:, :, 12] = nsq.reshape(nb, B)
    blk_pack[:, :, 13] = tvalid.reshape(nb, B).astype(np.float32)
    blk_pack[:, :, 14] = httr_blk.astype(np.float32)
    blk_pack[:, :, 15:18] = tnormal.reshape(nb, B, 3)
    blk_pack[:, :, 18] = np.where(
        tvalid.reshape(nb, B), mat_ior[tri_slice].reshape(nb, B), 1.0
    )  # padding ior 1.0 keeps fresnel math finite
    blk_pack[:, :, 19] = mat_opacity[tri_slice].reshape(nb, B)
    blk_pack[:, :, 20] = mat_metallic[tri_slice].reshape(nb, B)
    blk_pack[:, :, 21] = mat_color[tri_slice, 0].reshape(nb, B)
    blk_pack[:, :, 22:25] = mat_absorption[tri_slice].reshape(nb, B, 3)
    # cast-order copy BEFORE the trans-first permutation: the nearest-hit
    # scan needs the front-to-back block order (per-ray t-limit pruning)
    # and local slot indices matching the planar arrays / mat_pack rows
    cast_pack = blk_pack.copy()
    blk_has_trans = httr_blk.any(axis=1)
    if cfg.shadow_order == "light" and lp.shape[0]:
        # shadow-priority order (cfg.shadow_order): within each
        # trans/opaque section, scan blocks NEAREST the lights first — every
        # shadow segment converges at a light, so near-light geometry is
        # crossed (and opaquely hit) by the most (ray, light) pairs; hitting
        # it early saturates per-lane opacity sooner, letting the LANE_GATE
        # evolving gate skip later blocks. Semantically order-free (same
        # argument as the trans-first permutation above), but the f32
        # shadow-sum ORDER changes, so outputs are allclose — not
        # bit-identical (scripts/tpu_shadoworder_ab.py).
        lo, hi = aabb[:, 0:3], aabb[:, 3:6]
        ldist = np.full(nb, np.inf, np.float32)
        nonempty = (lo <= hi).all(axis=1)
        for lpt in np.asarray(lp, np.float32):
            dl = np.linalg.norm(np.clip(lpt, lo, hi) - lpt, axis=1)
            ldist = np.minimum(ldist, np.where(nonempty, dl, np.inf))
        blk_order = np.lexsort((ldist, ~blk_has_trans))
    else:
        blk_order = np.argsort(~blk_has_trans, kind="stable")
    blk_pack = blk_pack[blk_order]
    blk_aabb = aabb[blk_order]
    n_trans_blocks = int(blk_has_trans.sum())

    fields = dict(
        sph_center=sph_center,
        sph_r_sq=sph_r_sq,
        sph_valid=sph_valid,
        tri_woop=woop4.reshape(nb, B, 4, 3).transpose(0, 2, 3, 1).reshape(nb, 12, B),
        tri_nsq=nsq.reshape(nb, B),
        tri_normal3=planar(tnormal),
        tri_valid_f=planar(tvalid.astype(np.float32)),
        tri_httr_f=planar(mat_has_trans[tri_slice].astype(np.float32)),
        tri_ior=planar(mat_ior[tri_slice]),
        tri_op=planar(mat_opacity[tri_slice]),
        tri_met=planar(mat_metallic[tri_slice]),
        tri_colr=planar(mat_color[tri_slice, 0]),
        tri_absn=planar(mat_absorption[tri_slice]),
        tri_aabb=aabb,
        tri_saabb=saabb,
        mat_color=mat_color,
        mat_metallic=mat_metallic,
        mat_shininess=mat_shininess,
        mat_ior=mat_ior,
        mat_opacity=mat_opacity,
        mat_has_trans=mat_has_trans,
        mat_boost=mat_boost,
        mat_absorption=mat_absorption,
        obj_normal=obj_normal,
        mat_pack=mat_pack,
        light_pos=light_pos,
        light_color=light_color,
        light_intensity=light_intensity,
        light_pack=light_pack,
        sph_pack=sph_pack,
        trb_pack=trb_pack,
        tri_blk_pack=blk_pack,
        tri_blk_aabb=blk_aabb,
        tri_cast_pack=cast_pack,
    )
    static = dict(
        n_trans_blocks=n_trans_blocks,
        n_lights=L_real,
        n_spheres=S_pad,
        n_triangles=T_pad,
        tri_block=B,
        n_bigtris=P_pad,
        bigtri_trans=bool(mat_has_trans[S_pad : S_pad + P_pad].any()),
        bigtri_trans_rows=min(_round_up(n_big_trans, 8), P_pad) if n_big_trans else 0,
        block_has_trans=tuple(
            bool(
                mat_has_trans[
                    S_pad + P_pad + b * B : S_pad + P_pad + (b + 1) * B
                ].any()
            )
            for b in range(nb)
        ),
        sb_sizes=tuple(sb_sizes),
        # past ~80k triangles the resident SoA (~100 B/tri) outgrows VMEM;
        # switch to the HBM-streaming kernels (ref parity: the reference's
        # linear scan has no scene-size ceiling, raytracer.rs:180)
        streaming=T_pad > int(cfg.stream_triangles),
    )
    return fields, static
