// Direct + specular lighting with the hard-shadow scan, shared by the
// port's three shading kernels: rt_shadow_scan (one lane scans one shadow
// ray: light_shade.cu's (ray, light) items, the node kernels' form with a
// ray per lane and shade_eval_rows' light-lanes form) and
// rt_warp_shadow_scan (a warp shares the scan of one shadow ray: the node
// kernels' form with a warp per ray); rt_light_ray and rt_light_add
// (rt_light_terms, added), the lighting of one light, which every kernel
// runs per ray in light order.
//
// Replaces the shading core of the TPU kernels in
// hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py:
// `_light_sums` (line 1662) with its shadow scan (`_sphere_occl_comp` 803,
// `_bigtri_occl_split` 1188, `_tri_occl_lights_lanegate` /
// `_tri_occl_lights` 1370 / 1519). It follows the plain path
// (ops/shading.py::light_sums) operation by operation, one light at a time
// and its lights' terms added in light order; it does not copy the TPU
// kernel's rescaled pair math or its 8-light chunks, so only the f32 sum
// order over lights differs from the TPU (it matches the plain twin's
// order).
//
// Early exits, all exact: a light behind the surface (cos_in <= 0) has
// intensity and colour exactly 0 and skips its scan; a light's scan stops
// at the first opaque occluder, because an occluded light contributes
// nothing (can_reach is false and every term that reads the shadow sums is
// discarded). Only the first n_lights rows of the light pack are read: the
// pack is padded to a multiple of 8 rows, and the padding is never a light.
//
// The Morton blocks are scanned in storage order, transmissive blocks
// first. The JAX package's two switches that reorder the opaque blocks (a
// primed block first, blocks sorted by distance to the lights) are not
// ported: on an H100 they were slower wherever they acted (PERF.md).
#pragma once

#include "rt_common.cuh"
#include "rt_occlude.cuh"  // Occl, occl_tri, occl_pack, add_part

// The scene tables a shading kernel reads. Light rows: [pos3 | color3 |
// intensity | pad]; sphere rows (16 floats): [c3 | r^2 | ior | opacity |
// metallic | color.r | transmissive | absorption3 | valid | pad3];
// triangle rows (32 floats): rt_common.cuh.
struct ShadeScene {
  const float *lights, *sph, *trb, *blk, *blk_aabb;
  int n_lights, S, P, trans_rows, nb, B, n_trans_blocks, backface;
};

// Bytes of the small tables (the lights in use, spheres, big primitives)
// and whether they are staged in shared memory (the default 48 KB).
__host__ __device__ inline size_t rt_table_bytes(const ShadeScene& sc) {
  return sizeof(float) * ((size_t)sc.n_lights * 8 + (size_t)sc.S * 16 + (size_t)sc.P * 32);
}
__host__ __device__ inline bool rt_tables_fit(const ShadeScene& sc) {
  return rt_table_bytes(sc) <= 48 * 1024;
}

// Table pointers as a thread sees them: shared memory when staged.
struct Tables {
  const float *lights, *sph, *trb;
};

// Every thread of the block calls this (it synchronises) before any thread
// returns.
__device__ __forceinline__ Tables rt_stage_tables(const ShadeScene& sc, bool staged,
                                                  float* smem) {
  if (!staged) return Tables{sc.lights, sc.sph, sc.trb};
  const int nl = sc.n_lights * 8, ns = sc.S * 16, nt = sc.P * 32;
  for (int i = threadIdx.x; i < nl + ns + nt; i += blockDim.x)
    smem[i] = i < nl ? sc.lights[i] : (i < nl + ns ? sc.sph[i - nl] : sc.trb[i - nl - ns]);
  __syncthreads();
  return Tables{smem, smem + nl, smem + nl + ns};
}

// Shadow terms of the sphere row q for the shadow ray (so, ld, maxd) (JAX
// intersect.py::_sphere_occlusion): whether it is hit within maxd, and then
// *om_io = 1 - opacity * T_red (0 for an opaque sphere's 1 - 0: 1).
__device__ __forceinline__ bool occl_sphere(const float* q, float sox, float soy, float soz,
                                            float ldx, float ldy, float ldz, float maxd,
                                            bool bf, float* om_io) {
  const float ocx = sox - q[0], ocy = soy - q[1], ocz = soz - q[2];
  const float b = 2.0f * ((ldx * ocx + ldy * ocy) + ldz * ocz);
  const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - q[3];
  const float disc = b * b - 4.0f * c;
  const bool disc_pos = disc >= 0.0f;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = (-b - sq) * 0.5f;
  const float t1 = (-b + sq) * 0.5f;
  const bool t0v = (t0 >= 0.0f) && disc_pos;
  const bool t1v = (t1 >= 0.0f) && disc_pos;
  const bool use0 = t0v && (!t1v || (t0 < t1));
  const bool use1 = t1v && !use0;
  const float t = use0 ? t0 : (use1 ? t1 : RT_INF);
  bool sval = (use0 || use1) && (q[12] != 0.0f);
  const float ts = sval ? t : 0.0f;
  const float nvx = (sox + ldx * ts) - q[0];
  const float nvy = (soy + ldy * ts) - q[1];
  const float nvz = (soz + ldz * ts) - q[2];
  const float inv_n = 1.0f / sqrtf((nvx * nvx + nvy * nvy) + nvz * nvz);
  const float cs = (ldx * (nvx * inv_n) + ldy * (nvy * inv_n)) + ldz * (nvz * inv_n);
  const bool httr = q[8] != 0.0f;
  if (bf) sval = sval && ((cs < 0.75f) || httr);
  if (!(sval && t <= maxd)) return false;
  const float io = httr ? q[5] * rt_shadow_tr_red(-cs, q[4], q[6], q[7], true) : 0.0f;
  *om_io = 1.0f - io;
  return true;
}

// The first two packs of the shadow scan for one light: spheres (straight
// into the total), then the big primitives' partial sums; returns the
// totals (opq set => the rest was skipped).
__device__ __forceinline__ Occl rt_scan_front(const ShadeScene& sc, const Tables& tb, float sox,
                                              float soy, float soz, float ldx, float ldy,
                                              float ldz, float maxd) {
  const bool bf = sc.backface != 0;
  Occl tot = {0.0f, 0.0f, 0.0f, 0.0f, false};
  // spheres, straight into the total
  for (int s = 0; s < sc.S; ++s) {
    const float* q = tb.sph + s * 16;
    float om_io;
    if (!occl_sphere(q, sox, soy, soz, ldx, ldy, ldz, maxd, bf, &om_io)) continue;
    tot.dec += om_io;
    tot.opq = tot.opq || !(q[8] != 0.0f);
    tot.fr += q[9];
    tot.fg += q[10];
    tot.fb += q[11];
  }
  if (tot.opq) return tot;
  // big primitives: transmissive rows lead the pack
  {
    Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
    for (int r = 0; r < sc.P && !part.opq; ++r)
      occl_tri(tb.trb + r * 32, sox, soy, soz, ldx, ldy, ldz, maxd, bf, r < sc.trans_rows, &part);
    add_part(&tot, part);
  }
  return tot;
}

// The Morton blocks of the scan (transmissive blocks first), behind the
// block gate, each block's partial sums into *tot; stops at the first
// opaque hit.
__device__ __forceinline__ void rt_scan_blocks(const ShadeScene& sc, float sox, float soy,
                                               float soz, float ldx, float ldy, float ldz,
                                               float maxd, Occl* tot) {
  const bool bf = sc.backface != 0;
  const int ntb = sc.n_trans_blocks;
  const float ix = 1.0f / ldx, iy = 1.0f / ldy, iz = 1.0f / ldz;
  for (int b = 0; b < sc.nb; ++b) {
    if (!rt_gate(sc.blk_aabb + b * 8, sox, soy, soz, ix, iy, iz, maxd)) continue;
    if (occl_pack(sc.blk + (size_t)b * sc.B * 32, sc.B, sox, soy, soz, ldx, ldy, ldz, maxd, bf,
                  b < ntb, tot))
      return;
  }
}

// Full shadow scan for one light; returns the totals (opq set => the rest
// was skipped and the sums are not used). Per-pack partial sums are added
// to the total in the plain path's order: spheres, big primitives, then
// each Morton block. Kept in two parts: as one function, ptxas schedules
// the kernels that run it (light_shade, the node kernels' ray-per-lane and
// light-lanes forms) otherwise than the code they were measured with
// (PERF.md, section 6).
__device__ __forceinline__ Occl rt_shadow_scan(const ShadeScene& sc, const Tables& tb, float sox,
                                               float soy, float soz, float ldx, float ldy,
                                               float ldz, float maxd) {
  Occl tot = rt_scan_front(sc, tb, sox, soy, soz, ldx, ldy, ldz, maxd);
  if (!tot.opq) rt_scan_blocks(sc, sox, soy, soz, ldx, ldy, ldz, maxd, &tot);
  return tot;
}

// The superblock partition of the block gate of rt_warp_shadow_scan
// (rt_common.cuh::rt_warp_blocks over sc.blk_aabb). Each block is a
// superblock of its own (kernels._node_gate: sb_shift 0), so the gate is
// never WIDE.
struct WarpGate {
  const float* saabb;
  const int* sb_start;
  int nsb, sb_shift;
};

// rt_shadow_scan with a warp's lanes sharing the work, for the shadow rays
// `need` of the warp's K rays (records in `rays`: rt_common.cuh's RT_RAY
// layout, max distance in slot 9). Spheres: lane s tests sphere s; big
// primitives: lane l tests rows l and l + 32 of `big` (the pack staged in
// the 80-byte layout); Morton blocks: the crossed ones, in storage order,
// through rt_warp_blocks and occl_warp_block (RAGGED: sc.B is no multiple
// of 32). Transmissive hits are added in
// the one-thread scan's order (spheres into the total, each pack's partial
// sums then into the total), so the sums are rt_shadow_scan's bits; a ray
// with an opaque hit leaves the scan at once. Returns the rays that have an
// opaque occluder; the others' totals are sums[k * OCCL_SUMS + 0..3]. All
// 32 lanes.
template <int K, bool RAGGED>
__device__ __forceinline__ unsigned rt_warp_shadow_scan(const ShadeScene& sc, const WarpGate& g,
                                                        const float4* big, int lane,
                                                        const float* rays, float* sums,
                                                        unsigned need, float4* stage) {
  const bool bf = sc.backface != 0;
  unsigned alive = need, opq = 0;
  for (int k = 0; k < K; ++k) {
    if (!(alive >> k & 1u)) continue;
    const float* ray = rays + k * RT_RAY;
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
    bool blocked = false;
    for (int s0 = 0; s0 < sc.S && !blocked; s0 += 32) {
      const int s = s0 + lane;
      float q[16] = {0.0f};
      float om_io = 1.0f;
      bool hit = false;
      if (s < sc.S) {
        rt_load4<4>(sc.sph + s * 16, q);
        hit = occl_sphere(q, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], ray[9], bf, &om_io);
      }
      unsigned hits = __ballot_sync(RT_WARP, hit);
      if (!hits) continue;
      blocked = __any_sync(RT_WARP, hit && !(q[8] != 0.0f));
      while (hits && !blocked) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        t0 += __shfl_sync(RT_WARP, om_io, src);
        t1 += __shfl_sync(RT_WARP, q[9], src);
        t2 += __shfl_sync(RT_WARP, q[10], src);
        t3 += __shfl_sync(RT_WARP, q[11], src);
      }
    }
    if (blocked) {
      opq |= 1u << k;
      alive &= ~(1u << k);
    } else if (lane == 0) {
      float* tot = sums + k * OCCL_SUMS;
      tot[0] = t0;
      tot[1] = t1;
      tot[2] = t2;
      tot[3] = t3;
    }
  }
  __syncwarp();  // the totals are written
  if (alive) {
    unsigned who = alive, touched = 0;
    occl_warp_rows<K, true>(big, sc.trb, sc.P, sc.trans_rows, lane, rays, sums, &who, bf, &alive,
                            &opq, &touched);
    occl_warp_fold<K>(sums, lane, touched);
  }
  rt_warp_blocks<K, false>(
      sc.blk_aabb, g.saabb, g.sb_start, g.nsb, g.sb_shift, nullptr, lane, rays, alive,
      [&](int k) { return rays[k * RT_RAY + 9]; },
      [&](int b, unsigned who, float, bool) {
        occl_warp_block<K, RAGGED>(sc.blk + (size_t)b * sc.B * 32, sc.B, lane, rays, sums, who,
                                   bf, b < sc.n_trans_blocks, &alive, &opq, stage);
      });
  __syncwarp();  // every lane has read the records; the totals are written
  return opq;
}

// One point light seen from a surface point: the shadow ray (so, ld, maxd),
// the distance term and cos_in (PointLight::calculate_contribution_at,
// light.rs:261-300).
struct LightRay {
  float ldx, ldy, ldz, sox, soy, soz, maxd, ldist, cos_in;
};

__device__ __forceinline__ LightRay rt_light_ray(const float* L, float eps, float px, float py,
                                                 float pz, float nx, float ny, float nz) {
  LightRay q;
  const float ltx = L[0] - px, lty = L[1] - py, ltz = L[2] - pz;
  const float lt2 = (ltx * ltx + lty * lty) + ltz * ltz;
  const float inv_lt = 1.0f / sqrtf(lt2);
  q.ldx = ltx * inv_lt;
  q.ldy = lty * inv_lt;
  q.ldz = ltz * inv_lt;
  q.sox = px + q.ldx * eps;
  q.soy = py + q.ldy * eps;
  q.soz = pz + q.ldz * eps;
  const float dex = L[0] - q.sox, dey = L[1] - q.soy, dez = L[2] - q.soz;
  q.maxd = sqrtf((dex * dex + dey * dey) + dez * dez);
  q.ldist = sqrtf(lt2) + RT_EPS;
  q.cos_in = ((ltx * nx + lty * ny) + ltz * nz) / q.ldist;
  return q;
}

// One reachable light's direct and specular terms (t[0..2] direct, t[3..5]
// specular; (dec, fr, fg, fb): the shadow sums of its scan) and whether they
// are added: only where diffuse > 0, and t[3..5] only with has_spec.
__device__ __forceinline__ bool rt_light_terms(const float* L, const LightRay& q, float dec,
                                               float fr, float fg, float fb, float nx, float ny,
                                               float nz, float dx, float dy, float dz, float mcr,
                                               float mcg, float mcb, bool has_spec,
                                               float spec_exp, float* t) {
  const float combined = fminf(fmaxf(1.0f - dec, 0.0f), 1.0f);
  const float att = 0.95f * ((RT_EPS + q.ldist) + q.ldist * q.ldist);
  const float att_sig = (tanhf(att) + 1.0f) / 2.0f;
  const float ci = q.cos_in * L[6] * fminf(fmaxf(att_sig, 0.0f), 1.0f);
  // shadow filter division quirk (raytracer_renderer.rs:807-811)
  const float lcsr = (mcr * L[3]) / (1.0f - fr);
  const float lcsg = (mcg * L[4]) / (1.0f - fg);
  const float lcsb = (mcb * L[5]) / (1.0f - fb);
  const float dln = (nx * q.ldx + ny * q.ldy) + nz * q.ldz;
  const float diffuse = fmaxf(dln, 0.0f);
  const float c2 = 2.0f * dln;
  const float srx = q.ldx - c2 * nx, sry = q.ldy - c2 * ny, srz = q.ldz - c2 * nz;
  const float inv_sr = 1.0f / sqrtf((srx * srx + sry * sry) + srz * srz);
  const float sdot = fmaxf(((srx * inv_sr) * dx + (sry * inv_sr) * dy) + (srz * inv_sr) * dz, 0.0f);
  const float spec_f = has_spec ? powf(sdot, spec_exp) : 0.0f;
  const float lf = diffuse * ci * combined;
  const float sf = ci * combined * spec_f;
  t[0] = mcr * lcsr * lf;
  t[1] = mcg * lcsg * lf;
  t[2] = mcb * lcsb * lf;
  t[3] = L[3] * sf;
  t[4] = L[4] * sf;
  t[5] = L[5] * sf;
  return diffuse > 0.0f;
}

// rt_light_terms added to acc[0..2] / acc[3..5]. The port builds with
// --fmad=false, so a term keeps its bits whether it is added here or on
// another lane (rt_node.cuh::rt_node_light_lanes).
__device__ __forceinline__ void rt_light_add(const float* L, const LightRay& q, float dec,
                                             float fr, float fg, float fb, float nx, float ny,
                                             float nz, float dx, float dy, float dz, float mcr,
                                             float mcg, float mcb, bool has_spec,
                                             float spec_exp, float* acc) {
  float t[6];
  if (rt_light_terms(L, q, dec, fr, fg, fb, nx, ny, nz, dx, dy, dz, mcr, mcg, mcb, has_spec,
                     spec_exp, t)) {
    acc[0] += t[0];
    acc[1] += t[1];
    acc[2] += t[2];
    if (has_spec) {
      acc[3] += t[3];
      acc[4] += t[4];
      acc[5] += t[5];
    }
  }
}
