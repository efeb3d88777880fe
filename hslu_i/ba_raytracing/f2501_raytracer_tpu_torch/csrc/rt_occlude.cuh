// Shadow accumulators of one shadow ray over triangle rows, shared by the
// port's shading kernels (through rt_light.cuh) and its two occlusion
// kernels (occlude_triangles.cu, occlude_triangles_stream.cu).
//
// The sums are the plain path's (ops/intersect.py::_pack_occlusion; ref
// raytracer.rs:24-106): over the hits with t <= maxd,
//   dec = sum(1 - opacity * T_red)   (T_red: shadow Fresnel, red channel;
//                                     0 for an opaque occluder)
//   opq = any opaque hit
//   fr, fg, fb = sum(absorption)
// A ray's hits are added in storage order, whether one thread owns the ray
// (occl_pack, occl_blocks) or a warp does (occl_warp_rows, occl_warp_block),
// so its f32 sums are the same bits on every run and in both forms: no
// atomics, no tree.
#pragma once

#include "rt_common.cuh"

struct Occl {
  float dec, fr, fg, fb;
  bool opq;
};

// Shadow accumulators of one triangle row for the shadow ray (so, ld, maxd)
__device__ __forceinline__ void occl_tri(const float* __restrict__ w, float sox,
                                         float soy, float soz, float ldx, float ldy,
                                         float ldz, float maxd, bool backface,
                                         bool trans_section, Occl* acc) {
  float t;
  bool valid = rt_tri_test(w, sox, soy, soz, ldx, ldy, ldz, &t);
  const bool httr = w[14] != 0.0f;
  const float cos_nv = -rt_dot_normal(w, ldx, ldy, ldz);
  if (backface) valid = valid && ((-cos_nv < 0.75f) || httr);
  if (!(valid && t <= maxd)) return;
  float io = 0.0f;  // all-opaque rows: every hit decrements opacity fully
  if (trans_section && httr) io = w[19] * rt_shadow_tr_red(cos_nv, w[18], w[20], w[21], true);
  acc->dec += 1.0f - io;
  acc->opq = acc->opq || !httr;
  acc->fr += w[22];
  acc->fg += w[23];
  acc->fb += w[24];
}

__device__ __forceinline__ void add_part(Occl* tot, const Occl& part) {
  tot->dec += part.dec;
  tot->fr += part.fr;
  tot->fg += part.fg;
  tot->fb += part.fb;
  tot->opq = tot->opq || part.opq;
}

// Rows [0, n) of one pack (the big-primitive pack or one Morton block):
// the pack's partial sums are added to the total, as the plain path adds
// one `_pack_occlusion` result per pack. The scan of the pack stops at its
// first opaque hit. Returns tot->opq.
__device__ __forceinline__ bool occl_pack(const float* __restrict__ rows, int n, float sox,
                                          float soy, float soz, float ldx, float ldy,
                                          float ldz, float maxd, bool backface,
                                          bool trans_section, Occl* tot) {
  Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
  for (int c = 0; c < n && !part.opq; ++c)
    occl_tri(rows + c * 32, sox, soy, soz, ldx, ldy, ldz, maxd, backface, trans_section, &part);
  add_part(tot, part);
  return tot->opq;
}

// Morton blocks [b0, b1) of `pack` (nb, B, 32) in storage order, each
// behind the widened gate of its box in `aabb` (nb, 8) against the segment
// [0, maxd]; the shadow Fresnel runs only on blocks whose `block_httr`
// entry is non-zero (the per-block any-transmissive table). Stops at the
// first opaque hit and returns tot->opq: a ray that is occluded keeps
// whatever had been summed, which no caller reads.
__device__ __forceinline__ bool occl_blocks(const float* __restrict__ pack,
                                            const float* __restrict__ aabb,
                                            const float* __restrict__ block_httr, int b0,
                                            int b1, int B, float sox, float soy, float soz,
                                            float ldx, float ldy, float ldz, float ix,
                                            float iy, float iz, float maxd, bool backface,
                                            Occl* tot) {
  for (int b = b0; b < b1; ++b) {
    if (!rt_gate(aabb + b * 8, sox, soy, soz, ix, iy, iz, maxd)) continue;
    if (occl_pack(pack + (size_t)b * B * 32, B, sox, soy, soz, ldx, ldy, ldz, maxd, backface,
                  block_httr[b] != 0.0f, tot))
      return true;
  }
  return false;
}

// A warp's shadow sums in shared memory, 8 floats per ray: the total (dec,
// fr, fg, fb) and the current block's partial sums. They are touched only
// where a transmissive triangle is hit, which is rare.
#define OCCL_SUMS 8

// Rows [0, n) of one pack, staged in `stage` (rt_common.cuh: the first
// RT_ROW4 words of each row), for the shadow rays `who` of a warp: lane l
// tests rows l, l + 32, ... against each ray with occl_tri's arithmetic (ray
// record slot 9 is the max distance); rows below `trans_rows` run the shadow
// Fresnel of a transmissive hit, whose floats 20-27 are read from `rows`. An
// opaque hit sets the ray's bit in *opq and takes it out of *who and *alive.
// Otherwise the hit rows' contributions are added in row order into the
// pack's partial sums (the ballot's bits from the lowest, each lane's values
// by shuffle), which the rays marked in *touched already hold. All 32 lanes;
// RAGGED: n need not be a multiple of 32 (the last round tests whether its
// rows exist, so that every lane stays in each ballot).
template <int K, bool RAGGED>
__device__ __forceinline__ void occl_warp_rows(const float4* stage, const float* __restrict__ rows,
                                               int n, int trans_rows, int lane, const float* rays,
                                               float* sums, unsigned* who, bool backface,
                                               unsigned* alive, unsigned* opq, unsigned* touched) {
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const bool in = !RAGGED || c < n;
    float w[4 * RT_ROW4];
    if (in) rt_staged_row(stage, c, w);
    const bool httr = in && w[14] != 0.0f;
    float m[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // row floats 20-27
    bool have_m = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!(*who >> k & 1u)) continue;
      const float* ray = rays + k * RT_RAY;
      bool hit = false;
      float cos_nv = 0.0f;
      if (in) {
        float t;
        bool valid = rt_tri_test(w, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], &t);
        cos_nv = -rt_dot_normal(w, ray[3], ray[4], ray[5]);
        if (backface) valid = valid && ((-cos_nv < 0.75f) || httr);
        hit = valid && t <= ray[9];
      }
      unsigned hits = __ballot_sync(RT_WARP, hit);
      if (!hits) continue;
      if (__any_sync(RT_WARP, hit && !httr)) {
        *opq |= 1u << k;
        *alive &= ~(1u << k);
        *who &= ~(1u << k);
        continue;
      }
      float one_minus_io = 1.0f;
      if (hit) {
        if (!have_m) rt_load4<2>(rows + c * 32 + 20, m);
        have_m = true;
        float io = 0.0f;  // all-opaque rows: every hit decrements opacity fully
        if (c < trans_rows && httr) io = w[19] * rt_shadow_tr_red(cos_nv, w[18], m[0], m[1], true);
        one_minus_io = 1.0f - io;
      }
      float* part = sums + k * OCCL_SUMS + 4;
      const bool fresh = !(*touched >> k & 1u);
      float p0 = fresh ? 0.0f : part[0], p1 = fresh ? 0.0f : part[1];
      float p2 = fresh ? 0.0f : part[2], p3 = fresh ? 0.0f : part[3];
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        p0 += __shfl_sync(RT_WARP, one_minus_io, src);
        p1 += __shfl_sync(RT_WARP, m[2], src);
        p2 += __shfl_sync(RT_WARP, m[3], src);
        p3 += __shfl_sync(RT_WARP, m[4], src);
      }
      __syncwarp();  // every lane has read the partial sums
      if (lane == 0) {
        part[0] = p0;
        part[1] = p1;
        part[2] = p2;
        part[3] = p3;
      }
      __syncwarp();
      *touched |= 1u << k;
    }
  }
}

// The partial sums of the rays in `touched` into their totals, as add_part
// adds them (a ray without a hit in the pack adds zeros: its total stays).
template <int K>
__device__ __forceinline__ void occl_warp_fold(float* sums, int lane, unsigned touched) {
  if (lane < K && (touched >> lane & 1u)) {
    float* tot = sums + lane * OCCL_SUMS;
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[i] += tot[4 + i];
  }
  if (touched) __syncwarp();
}

// One Morton block (B rows) for the shadow rays `who` of a warp: the rows go
// through `stage` (rt_common.cuh::rt_stage_rows) into occl_warp_rows, and
// the block's partial sums into each ray's total, as occl_pack adds them:
// bit for bit the sums of the one-thread scan, on every run.
// `trans_section`: the block runs the shadow Fresnel. RAGGED: B need not be
// a multiple of 32 (without it, the rounds skip the test of whether their
// rows exist, which costs registers in the streamed scan).
template <int K, bool RAGGED>
__device__ __forceinline__ void occl_warp_block(const float* __restrict__ blk, int B, int lane,
                                                const float* rays, float* sums, unsigned who,
                                                bool backface, bool trans_section,
                                                unsigned* alive, unsigned* opq,
                                                float4* stage) {
  unsigned touched = 0;  // rays with partial sums in this block
  for (int c0 = 0; c0 < B; c0 += RT_STAGE_ROWS) {
    const int n = min(RT_STAGE_ROWS, B - c0);
    rt_stage_rows(stage, blk + c0 * 32, n, lane);
    occl_warp_rows<K, RAGGED>(stage, blk + c0 * 32, n, trans_section ? n : 0, lane, rays, sums,
                              &who, backface, alive, opq, &touched);
  }
  occl_warp_fold<K>(sums, lane, touched);
}

__device__ __forceinline__ void occl_store(const Occl& tot, int r, float* __restrict__ dec,
                                           unsigned char* __restrict__ opq,
                                           float* __restrict__ fsub) {
  dec[r] = tot.dec;
  opq[r] = tot.opq ? 1 : 0;
  fsub[3 * r] = tot.fr;
  fsub[3 * r + 1] = tot.fg;
  fsub[3 * r + 2] = tot.fb;
}
