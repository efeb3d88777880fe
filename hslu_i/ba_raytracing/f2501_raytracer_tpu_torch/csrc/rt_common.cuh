// Device helpers shared by all of the port's CUDA kernels. Every formula
// follows the plain PyTorch twin in ops/intersect.py / ops/shading.py /
// ops/trace.py operation by operation,
// in the same order: the build uses --fmad=false and no fast math, so a
// kernel and its twin round alike.
//
// Triangle row layout (scene/device.py, 32 floats per triangle, the JAX
// package's trb_pack lane map): 0-11 Woop coefficients (3k+c: input
// component k, output coordinate c; 9-11 translation), 12 |n|^2, 13 valid,
// 14 transmissive, 15-17 shading normal, 18 ior, 19 opacity, 20 metallic,
// 21 color.r, 22-24 absorption.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_EPS 1.1920928955078125e-07f  // f32::EPSILON = 2^-23
#define RT_INF __int_as_float(0x7f800000)

// Woop ray/triangle test (JAX intersect.py::_tri_block_ts): returns validity
// (no backface term) and t.
__device__ __forceinline__ bool rt_tri_test(const float* __restrict__ w, float ox,
                                            float oy, float oz, float dx, float dy,
                                            float dz, float* t_out) {
  const float uo = ((ox * w[0] + oy * w[3]) + oz * w[6]) + w[9];
  const float vo = ((ox * w[1] + oy * w[4]) + oz * w[7]) + w[10];
  const float wo = ((ox * w[2] + oy * w[5]) + oz * w[8]) + w[11];
  const float ud = (dx * w[0] + dy * w[3]) + dz * w[6];
  const float vd = (dx * w[1] + dy * w[4]) + dz * w[7];
  const float wd = (dx * w[2] + dy * w[5]) + dz * w[8];
  const float t = -wo / wd;
  const float u = uo + t * ud;
  const float v = vo + t * vd;
  const float det = wd * w[12];  // = d . n = det([d, -e1, -e2])
  *t_out = t;
  return (t > RT_EPS) && (u >= 0.0f) && (v >= 0.0f) && (u + v < 1.0f) &&
         (fabsf(det) > RT_EPS) && (w[13] != 0.0f);
}

// d . shading normal of a triangle row, left to right
__device__ __forceinline__ float rt_dot_normal(const float* __restrict__ w, float dx,
                                               float dy, float dz) {
  return (dx * w[15] + dy * w[16]) + dz * w[17];
}

// One slab of the AABB gate. The TPU kernel (pallas_kernels.py::_gate_flat)
// relies on jnp.minimum/maximum PROPAGATING NaN (0 * inf when a direction
// component is 0 and the origin lies on the slab plane) and then maps a NaN
// lo to -inf and a NaN hi to +inf. fminf/fmaxf DROP NaN instead, which would
// cull a block that must be tested, so the NaN case is spelled out here.
__device__ __forceinline__ void rt_slab(float lo, float hi, float o, float inv,
                                        float* tn, float* tf) {
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  const bool nan = isnan(t1) || isnan(t2);
  const float a = nan ? -RT_INF : fminf(t1, t2);
  const float b = nan ? RT_INF : fmaxf(t1, t2);
  *tn = fmaxf(*tn, a);
  *tf = fminf(*tf, b);
}

// Relative widening of every gate box face. f32 rounding in the slab test
// and in the Woop hit can disagree by a few ulp, so an exact box could cull
// a block whose hit lies on its face (the procedural text mesh is made of
// axis-aligned boxes). A margin of 1e-5 * (1 + |coordinate|) is far above
// that rounding (~1e-7 relative) and keeps the gate conservative: a block
// holding a hit nearer than t_limit is never culled, so the gated kernels
// return exactly what their ungated twins return.
#define RT_GATE_REL 1e-5f

// Does the segment [0, t_limit] of the ray cross the (widened) box?
// box: [min xyz | max xyz | pad 2].
__device__ __forceinline__ bool rt_gate(const float* __restrict__ box, float ox,
                                        float oy, float oz, float ix, float iy,
                                        float iz, float t_limit) {
  float tn = -RT_INF, tf = RT_INF;
  const float o3[3] = {ox, oy, oz};
  const float i3[3] = {ix, iy, iz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = box[c], hi = box[c + 3];
    const float m = RT_GATE_REL * (1.0f + fmaxf(fabsf(lo), fabsf(hi)));
    rt_slab(lo - m, hi + m, o3[c], i3[c], &tn, &tf);
  }
  return (tf >= fmaxf(tn, 0.0f)) && (tn <= t_limit);
}

// ---- warp-level helpers: a warp owns K rays (the cast, node and streamed
// kernels) ------------------------------------------------------------------
//
// K is 1 where rays are few (a wavefront of the pool: every ray needs a warp
// of its own to fill the card) and 8 where they are many: a block of rows is
// then loaded once and tested against up to 8 rays, which cuts the L2
// traffic of coherent rays (neighbouring pixels cross the same blocks) by up
// to 8 and costs incoherent ones nothing, since a ray is still tested only
// against the blocks its own segment crosses.

#define RT_WARP 0xffffffffu
#define RT_WARPS 4  // warps per thread block (8 measured 1-9% slower on an H100)

// A ray's record in shared memory, read by all lanes from one address:
// o 0-2, d 3-5, 1/d 6-8, max distance 9 (occlusion), 10-11 spare
#define RT_RAY 12

// Ray `r` into `rec`
__device__ __forceinline__ void rt_ray_record(float* rec, const float* __restrict__ o,
                                              const float* __restrict__ d, int r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dc = d[3 * r + c];
    rec[c] = o[3 * r + c];
    rec[3 + c] = dc;
    rec[6 + c] = 1.0f / dc;
  }
}

// The first 4*N4 floats of a 16-byte aligned row, as 16-byte loads
template <int N4>
__device__ __forceinline__ void rt_load4(const float* __restrict__ row, float* w) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    const float4 v = __ldg(q + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Rows staged in shared memory: the first RT_ROW4 16-byte words (20 floats:
// all that a pair test reads) of up to RT_STAGE_ROWS rows, 80 bytes apart,
// which lanes read without bank conflicts. A lane that loaded its own rows
// from global memory would touch 32 cache lines per instruction; the copy
// below reads each line of the block once for the whole warp.
#define RT_ROW4 5
#define RT_STAGE_ROWS 64

// Copies the first RT_ROW4 words of rows [0, n) at `rows` into `stage`,
// consecutive lanes taking consecutive words (cp.async: global to shared
// without passing through registers), and waits for them. All 32 lanes.
__device__ __forceinline__ void rt_stage_rows(float4* stage, const float* __restrict__ rows,
                                              int n, int lane) {
  __syncwarp();  // every lane has read what the stage held
  for (int i = lane; i < n * RT_ROW4; i += 32) {
    const float* src = rows + (i / RT_ROW4) * 32 + (i % RT_ROW4) * 4;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(stage + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
}

// The first RT_ROW4 words of rows [0, n) at `rows` into `stage`, by every
// thread of the thread block, which must all call this (it synchronises)
// before any of them returns: a table that all of the block's warps read
// (the big-primitive pack).
__device__ __forceinline__ void rt_stage_block_rows(float4* stage, const float* __restrict__ rows,
                                                    int n) {
  for (int i = threadIdx.x; i < n * RT_ROW4; i += blockDim.x)
    stage[i] = __ldg(reinterpret_cast<const float4*>(rows + (i / RT_ROW4) * 32) + i % RT_ROW4);
  __syncthreads();
}

// Row c of the stage
__device__ __forceinline__ void rt_staged_row(const float4* stage, int c, float* w) {
#pragma unroll
  for (int i = 0; i < RT_ROW4; ++i) {
    const float4 v = stage[c * RT_ROW4 + i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// A box row by two 16-byte loads. Returns false for a box whose min lies
// above its max, the mark scene/device.py gives an empty block (and a
// superblock of one): it holds nothing and counts as missed, where the slab
// test alone would read it as the box between its swapped faces.
__device__ __forceinline__ bool rt_load_box(const float* __restrict__ row, float* box) {
  rt_load4<2>(row, box);
  return !(box[0] > box[3] || box[1] > box[4] || box[2] > box[5]);
}

// rt_gate for a ray record
__device__ __forceinline__ bool rt_gate_ray(const float* box, const float* ray,
                                            float t_limit) {
  return rt_gate(box, ray[0], ray[1], ray[2], ray[6], ray[7], ray[8], t_limit);
}

// Which of the rays in `rays` (a bit per ray) cross `box` within their limit
template <int K, class Limit>
__device__ __forceinline__ unsigned rt_gate_rays(const float* box, const float* rays,
                                                 unsigned which, Limit limit) {
  unsigned crossing = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((which >> k & 1u) && rt_gate_ray(box, rays + k * RT_RAY, limit(k))) crossing |= 1u << k;
  return crossing;
}

// The two-level box gate of a warp that owns K rays (`alive`: a bit per ray
// still in play; `limit(k)`: ray k's segment end). Lane l tests the superbox
// 32i + l of `saabb` against every live ray; the superblocks that any ray
// crosses are taken in storage order. Without WIDE (no superblock holds more
// than 2^sb_shift <= 32 blocks), 32 >> sb_shift of them go in one step, lane
// l testing block (l & (2^sb_shift - 1)) of superblock (l >> sb_shift);
// with WIDE (sb_shift > 5), a superblock goes alone, its blocks in rounds of
// 32, lane l testing block 32j + l in round j. WIDE is a build of its own,
// chosen at launch, so that the usual partition keeps its registers.
// `visit(b, who, flag, first)` then runs, warp-uniform, for every block b in
// storage order that the rays `who` cross; `flag` is block_flag[b] (0
// without a table), loaded beside the box so that visit need not wait for
// it, and `first` says that b is the first block since the boxes were
// tested. A limit may shrink inside visit (the cast's best t) and visit may
// take rays out of `alive`: later gates see both. Both levels are
// conservative (a superbox is the union of its boxes), so a ray visits
// every block that holds a hit within its limit. All 32 lanes call this
// together.
template <int K, bool WIDE, class Limit, class Visit>
__device__ __forceinline__ void rt_warp_blocks(const float* __restrict__ aabb,
                                               const float* __restrict__ saabb,
                                               const int* __restrict__ sb_start, int nsb,
                                               int sb_shift,
                                               const float* __restrict__ block_flag, int lane,
                                               const float* rays, const unsigned& alive,
                                               Limit limit, Visit visit) {
  const int shift = WIDE ? 5 : sb_shift;
  const int per_step = 32 >> shift;
  const int slot = lane >> shift, member = lane & ((1 << shift) - 1);
  float box[8];
  for (int g0 = 0; g0 < nsb && alive; g0 += 32) {
    const int g = g0 + lane;
    int first = 0, count = 0;
    unsigned sees = 0;  // the rays that cross this lane's superbox
    if (g < nsb) {
      first = sb_start[g];
      count = sb_start[g + 1] - first;
      if (rt_load_box(saabb + (size_t)g * 8, box)) sees = rt_gate_rays<K>(box, rays, alive, limit);
    }
    unsigned groups = __ballot_sync(RT_WARP, sees != 0);
    while (groups && alive) {
      // this step's superblocks: the lowest per_step set bits of `groups`
      unsigned mine = 0xffffffffu;
      for (int i = 0; i < per_step && groups; ++i) {
        if (i == slot) mine = __ffs(groups) - 1;
        groups &= groups - 1;
      }
      const int src = (mine == 0xffffffffu) ? 0 : (int)mine;
      const int b0 = __shfl_sync(RT_WARP, first, src) + member;
      const int n = __shfl_sync(RT_WARP, count, src);
      const unsigned cand = __shfl_sync(RT_WARP, sees, src) & alive;
      // one round; with WIDE, the rounds of the step's one superblock (n is
      // the same on every lane), each against the rays still alive
      for (int m0 = 0;; m0 += 32) {
        const int b = b0 + m0;
        const unsigned who_may = WIDE ? cand & alive : cand;
        unsigned in_box = 0;  // the rays that cross this lane's box
        float flag = 0.0f;
        if (mine != 0xffffffffu && m0 + member < n && who_may) {
          if (block_flag) flag = block_flag[b];
          if (rt_load_box(aabb + (size_t)b * 8, box))
            in_box = rt_gate_rays<K>(box, rays, who_may, limit);
        }
        unsigned blocks = __ballot_sync(RT_WARP, in_box != 0);
        bool first_visit = true;
        while (blocks && alive) {
          const int owner = __ffs(blocks) - 1;
          blocks &= blocks - 1;
          const int bb = __shfl_sync(RT_WARP, b, owner);
          const unsigned who = __shfl_sync(RT_WARP, in_box, owner) & alive;
          const float bb_flag = __shfl_sync(RT_WARP, flag, owner);
          if (!who) continue;
          visit(bb, who, bb_flag, first_visit);
          first_visit = false;
        }
        if (!WIDE || m0 + 32 >= n || !alive) break;
      }
    }
  }
}

// Runs the statement `...` with FLAG a constexpr bool equal to COND: the
// build of a template for each value, chosen at launch. It nests.
#define RT_BOOL_SWITCH(COND, FLAG, ...) \
  do {                                  \
    if (COND) {                         \
      constexpr bool FLAG = true;       \
      __VA_ARGS__;                      \
    } else {                            \
      constexpr bool FLAG = false;      \
      __VA_ARGS__;                      \
    }                                   \
  } while (0)

// One Morton block of `pack` (nb, B, 32; any B) for the casts of a warp's
// rays `who`: the rows go through `stage` (RT_STAGE_ROWS * RT_ROW4 words of
// the warp's own), lane l tests rows l, l + 32, ... against each ray (a
// lane past the last row of a ragged round tests nothing, and no collective
// runs inside the round), keeping per ray its own best (t, index) under a strict `<`, so
// within a lane the lower slot keeps a tie; slot (b, c) has the index
// base + b*B + c. Afterwards
// best_t[k] is the warp's best t, and a ray whose best t shrank is marked in
// *stale: the boxes were tested against the old one, so such a ray is first
// tested again against this block's box and left out if the segment
// [0, best_t[k]] now misses it. A valid t is > 0, so its bits order as an
// unsigned integer and one `redux` instruction takes the minimum.
template <int K>
__device__ __forceinline__ void rt_warp_cast_block(const float* __restrict__ pack,
                                                   const float* __restrict__ aabb, int b, int B,
                                                   int base, int lane, const float* rays,
                                                   unsigned who,
                                                   bool backface, float* lane_t, int* lane_idx,
                                                   float* best_t, unsigned* stale,
                                                   float4* stage) {
  if (who & *stale) {
    float box[8];
    rt_load4<2>(aabb + (size_t)b * 8, box);
    who = (who & ~*stale) |
          rt_gate_rays<K>(box, rays, who & *stale, [&](int k) { return best_t[k]; });
    if (!who) return;
  }
  const float* blk = pack + (size_t)b * B * 32;
  for (int c0 = 0; c0 < B; c0 += RT_STAGE_ROWS) {
    const int n = min(RT_STAGE_ROWS, B - c0);
    rt_stage_rows(stage, blk + c0 * 32, n, lane);
    for (int c = lane; c < n; c += 32) {
      float w[4 * RT_ROW4];
      rt_staged_row(stage, c, w);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!(who >> k & 1u)) continue;
        const float* ray = rays + k * RT_RAY;
        float t;
        bool valid = rt_tri_test(w, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], &t);
        if (backface)
          valid = valid && ((rt_dot_normal(w, ray[3], ray[4], ray[5]) < 0.75f) || (w[14] != 0.0f));
        if (valid && t < lane_t[k]) {
          lane_t[k] = t;
          lane_idx[k] = base + b * B + c0 + c;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!(who >> k & 1u)) continue;
    const float t = __uint_as_float(__reduce_min_sync(RT_WARP, __float_as_uint(lane_t[k])));
    if (t < best_t[k]) *stale |= 1u << k;
    best_t[k] = t;
  }
}

// The warp's nearest hit from its lanes' bests: the smallest t and, among
// the lanes that hold it, the lowest index. With blocks visited in any order
// and skipped only when they cannot hold a hit within the best t so far,
// that is the plain scan's answer: the earlier pack, the earlier block and
// the lower slot win a tie. A miss is (+inf, 2^31-1).
__device__ __forceinline__ int rt_warp_nearest(float lane_t, int lane_idx, float best_t) {
  const unsigned mine = (lane_t == best_t) ? (unsigned)lane_idx : 0x7fffffffu;
  return (int)__reduce_min_sync(RT_WARP, mine);
}

// x**5 in XLA's binary-exponentiation order, as ops/intersect.py::pow5
__device__ __forceinline__ float rt_pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// Red channel of the shadow Fresnel transmittance 1 - F through a
// transmissive occluder (JAX intersect.py::_shadow_transmittance_red;
// ref material.rs:467-525 with other_ior = 1, raytracer.rs:57-74).
__device__ __forceinline__ float rt_shadow_tr_red(float cos_nv, float ior, float met,
                                                  float col_r, bool httr) {
  const float cos_theta = fabsf(cos_nv);
  const bool inside = cos_nv < 0.0f;
  const float eta_t = inside ? ior : 1.0f / ior;
  const float sin2_t = eta_t * eta_t * (1.0f - cos_theta * cos_theta);
  const bool refl = met > 0.0f;
  const bool tir = (httr && inside && (sin2_t > 1.0f)) || refl;
  const float q = (1.0f - ior) / (1.0f + ior);
  const float f0 = q * q;
  const float f0r = f0 + (col_r - f0) * met;
  const float fres = f0r + (1.0f - f0r) * rt_pow5(1.0f - cos_theta);
  float f = tir ? (refl ? met : 1.0f) : fres;
  f = httr ? f : met;
  return 1.0f - f;
}
