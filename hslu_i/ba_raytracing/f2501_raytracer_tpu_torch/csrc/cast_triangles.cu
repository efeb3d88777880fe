// Nearest-hit triangle cast for the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_cast_kernel` (line 301) behind `pallas_cast_triangles` (line 405).
//
// What it computes: for every ray, the nearest valid hit over the
// big-primitive pack (trb_pack, P rows) and then over the Morton blocks of
// tri_cast_pack (nb blocks of B rows), strict `<` across candidates in that
// order, so equal t keeps the lowest index. Index space as the TPU kernel:
// big primitive p -> p, Morton slot (b, c) -> P + b*B + c; a miss is
// t = +inf, idx = 2^31-1. Rays are read as given, (R, 3).
//
// What bounds it on this card: operations, ~40 f32 operations and a divide
// per (ray, triangle) pair; the inputs are 24 B per ray and a few KB of
// scene. The semesterbild scene at 1080p has P = 48 and 2 blocks of 64,
// ~180 pairs per ray before gating. The path sends it a tile's primary rays
// (R = 131072, 16 launches per 1080p frame) and, 2496 times per frame, a
// pool wavefront of W = 2048 rays. With one thread per ray a wavefront was
// 16 thread blocks on 132 SMs, and a ray's time one thread's chain of ~180
// dependent pair tests: the latency of that chain bounded it.
//
// Design: one kernel template, its form chosen by the ray count
// (kernels.rays_per_warp). Below PACKET_MIN_RAYS (a wavefront) a warp owns
// a ray, 4 warps per thread block, so a wavefront is 2048 warps. The big
// rows are staged once per thread block into shared memory, 80 bytes a row
// (rt_common.cuh: RT_ROW4 words; lanes read their own rows without bank
// conflicts), and lane l tests rows l and l + 32; the warp's minimum t is
// then the limit of the two-level box gate over tri_saabb / sb_start
// (rt_warp_blocks), and each crossed block's rows are staged and split over
// the lanes (rt_warp_cast_block). Each lane keeps its own best (t, index)
// under a strict `<`; one lexicographic minimum over the lanes
// (rt_warp_nearest) is the one-thread scan's answer, ties included: a big
// primitive's index is below every Morton index, and an earlier block's
// below a later one's. From PACKET_MIN_RAYS on (a tile's coherent primary
// rays) a warp takes 32 rays, a ray per lane, and each lane scans its ray
// in order, as one thread did: the lanes then walk the same rows at once,
// which shared memory and the L1 serve as broadcasts (eight rays per warp
// with the lanes over rows took twice as long there). The gate boxes are
// widened (rt_common.cuh), so every form equals the ungated plain twin bit
// for bit. Any block partition: superblocks of more than 32 blocks go in
// rounds of 32 lanes (the WIDE build, chosen at launch, so that the usual
// partition keeps its registers), and a ragged last round of rows leaves
// lanes idle (no collective runs inside a round). Shared memory: P * 80 B of big rows,
// and in the warp form 20 KB of staged block rows and 48 B of ray record per
// warp.
#include "rt_common.cuh"

namespace {

// A ray per lane (K = 32, a tile's coherent primary rays): the lane scans
// its ray alone, in order, with the gates against its own best t; the lanes
// of a warp mostly walk the same rows at once, which the staged big rows and
// the L1 serve as broadcasts.
__device__ __forceinline__ void lane_cast(int r, const float* __restrict__ o,
                                          const float* __restrict__ d, const float4* big,
                                          int P, const float* __restrict__ pack, int B,
                                          const float* __restrict__ aabb,
                                          const float* __restrict__ saabb,
                                          const int* __restrict__ sb_start, int nsb, bool bf,
                                          float* __restrict__ t_out, int* __restrict__ idx_out) {
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float best_t = RT_INF;
  int best_idx = 0x7fffffff;
  for (int p = 0; p < P; ++p) {
    float w[4 * RT_ROW4];
    rt_staged_row(big, p, w);
    float t;
    bool valid = rt_tri_test(w, ox, oy, oz, dx, dy, dz, &t);
    if (bf) valid = valid && ((rt_dot_normal(w, dx, dy, dz) < 0.75f) || (w[14] != 0.0f));
    if (valid && t < best_t) {
      best_t = t;
      best_idx = p;
    }
  }
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  for (int g = 0; g < nsb; ++g) {
    const int b0 = sb_start[g], b1 = sb_start[g + 1];
    if (b1 - b0 > 1 && !rt_gate(saabb + g * 8, ox, oy, oz, ix, iy, iz, best_t)) continue;
    for (int b = b0; b < b1; ++b) {
      if (!rt_gate(aabb + b * 8, ox, oy, oz, ix, iy, iz, best_t)) continue;
      const float* blk = pack + (size_t)b * B * 32;
      for (int c = 0; c < B; ++c) {
        const float* w = blk + c * 32;
        float t;
        bool valid = rt_tri_test(w, ox, oy, oz, dx, dy, dz, &t);
        if (bf) valid = valid && ((rt_dot_normal(w, dx, dy, dz) < 0.75f) || (w[14] != 0.0f));
        if (valid && t < best_t) {
          best_t = t;
          best_idx = P + b * B + c;
        }
      }
    }
  }
  t_out[r] = best_t;
  idx_out[r] = best_idx;
}

// A warp per ray (K = 1; the template takes K consecutive rays from r0):
// the lanes share each ray's scan (see the note above). WIDE: superblocks
// of more than 32 blocks (rt_common.cuh::rt_warp_blocks).
template <int K, bool WIDE>
__device__ __forceinline__ void warp_cast(int r0, int lane, const float* __restrict__ o,
                                          const float* __restrict__ d, int R, const float4* big,
                                          int P, const float* __restrict__ pack, int B,
                                          const float* __restrict__ aabb,
                                          const float* __restrict__ saabb,
                                          const int* __restrict__ sb_start, int nsb,
                                          int sb_shift, bool bf, float* rays, float4* stage,
                                          float* __restrict__ t_out, int* __restrict__ idx_out) {
  if (lane < K && r0 + lane < R) rt_ray_record(rays + lane * RT_RAY, o, d, r0 + lane);
  __syncwarp();
  const unsigned alive = (r0 + K <= R) ? (1u << K) - 1u : (1u << (R - r0)) - 1u;

  float lane_t[K], best_t[K];
  int lane_idx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lane_t[k] = RT_INF;
    lane_idx[k] = 0x7fffffff;
  }
  // big primitives (walls, floors): never culled
  for (int c = lane; c < P; c += 32) {
    float w[4 * RT_ROW4];
    rt_staged_row(big, c, w);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!(alive >> k & 1u)) continue;
      const float* ray = rays + k * RT_RAY;
      float t;
      bool valid = rt_tri_test(w, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], &t);
      if (bf) valid = valid && ((rt_dot_normal(w, ray[3], ray[4], ray[5]) < 0.75f) || (w[14] != 0.0f));
      if (valid && t < lane_t[k]) {
        lane_t[k] = t;
        lane_idx[k] = c;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    best_t[k] = __uint_as_float(__reduce_min_sync(RT_WARP, __float_as_uint(lane_t[k])));

  // Morton blocks, behind the superblock and block gates against the best t
  unsigned stale = 0;  // rays whose best t shrank since the boxes were tested
  rt_warp_blocks<K, WIDE>(
      aabb, saabb, sb_start, nsb, sb_shift, nullptr, lane, rays, alive,
      [&](int k) { return best_t[k]; },
      [&](int b, unsigned who, float, bool first) {
        if (first) stale = 0;
        rt_warp_cast_block<K>(pack, aabb, b, B, P, lane, rays, who, bf, lane_t, lane_idx, best_t,
                              &stale, stage);
      });
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int best_idx = rt_warp_nearest(lane_t[k], lane_idx[k], best_t[k]);
    if (lane == k && r0 + k < R) {
      t_out[r0 + k] = best_t[k];
      idx_out[r0 + k] = best_idx;
    }
  }
}

template <int K, bool WIDE>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) cast_triangles_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int R,
    const float* __restrict__ trb, int P, const float* __restrict__ pack, int B,
    const float* __restrict__ aabb, const float* __restrict__ saabb,
    const int* __restrict__ sb_start, int nsb, int sb_shift, int backface,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  constexpr bool per_lane = K == 32;
  extern __shared__ float4 s_big[];  // P rows of RT_ROW4 words
  __shared__ float s_rays[RT_WARPS][per_lane ? 1 : K * RT_RAY];
  __shared__ float4 s_stage[RT_WARPS][per_lane ? 1 : RT_STAGE_ROWS * RT_ROW4];
  rt_stage_block_rows(s_big, trb, P);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * RT_WARPS + warp) * K;
  if constexpr (per_lane) {
    if (r0 + lane < R)
      lane_cast(r0 + lane, o, d, s_big, P, pack, B, aabb, saabb, sb_start, nsb, backface != 0,
                t_out, idx_out);
  } else {
    if (r0 >= R) return;  // by whole warps: the shuffles below need all 32 lanes
    warp_cast<K, WIDE>(r0, lane, o, d, R, s_big, P, pack, B, aabb, saabb, sb_start, nsb,
                       sb_shift, backface != 0, s_rays[warp], s_stage[warp], t_out, idx_out);
  }
}
template <int K, bool WIDE>
void launch(const float* o, const float* d, int R, const float* trb, int P, const float* pack,
            int B, const float* aabb, const float* saabb, const int* sb_start, int nsb,
            int sb_shift, int backface, float* t_out, int* idx_out, cudaStream_t stream) {
  const int per_block = RT_WARPS * K;
  cast_triangles_kernel<K, WIDE><<<(R + per_block - 1) / per_block, 32 * RT_WARPS,
                             sizeof(float4) * RT_ROW4 * P, stream>>>(
      o, d, R, trb, P, pack, B, aabb, saabb, sb_start, nsb, sb_shift, backface, t_out, idx_out);
}

}  // namespace

// rays_per_warp: 1 or 32 (a ray per lane)
extern "C" int rt_cast_triangles(const float* o, const float* d, int R, const float* trb,
                                 int P, const float* pack, int nb, int B,
                                 const float* aabb, const float* saabb,
                                 const int* sb_start, int nsb, int sb_shift, int rays_per_warp,
                                 int backface, float* t_out, int* idx_out, void* stream) {
  (void)nb;
  if (rays_per_warp != 1 && rays_per_warp != 32) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    if (rays_per_warp == 32)  // the one-thread scan: any superblock
      launch<32, false>(o, d, R, trb, P, pack, B, aabb, saabb, sb_start, nsb, sb_shift, backface,
                        t_out, idx_out, (cudaStream_t)stream);
    else
      RT_BOOL_SWITCH(sb_shift > 5, WIDE,
                     launch<1, WIDE>(o, d, R, trb, P, pack, B, aabb, saabb, sb_start, nsb,
                                     sb_shift, backface, t_out, idx_out, (cudaStream_t)stream));
  }
  return (int)cudaGetLastError();
}
