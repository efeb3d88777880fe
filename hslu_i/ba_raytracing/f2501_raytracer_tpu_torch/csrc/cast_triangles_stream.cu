// Nearest Morton-slot hit for scenes past `stream_triangles`, for the
// PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_cast_stream_kernel` (line 473) behind `pallas_cast_triangles_stream`
//   (line 539). ops/intersect.py::cast_rays takes it when `scene.streaming`;
//   spheres and the big-primitive pack stay plain PyTorch there, as they
//   stay XLA in the JAX package.
//
// What it computes: for every ray, the nearest valid hit over the Morton
// blocks of tri_cast_pack (nb blocks of B rows, 32 floats per triangle):
// on equal t the earlier block and the lower slot win. Output: t (R,) and
// the local slot b*B + c (R,) int32; a miss is t = +inf, idx = 2^31-1.
//
// "Streamed" on the TPU means the blocks do not fit its fast memory and a
// (block x ray-tile) grid carries the running minimum in scratch. On this
// card the scene (a few tens of MB) sits in the L2, and nothing is staged.
//
// What bounds it on this card: a ray needs the boxes it crosses and ~40 f32
// operations for each of the B triangles of a crossed block, a few thousand
// operations in all, but each step (superboxes, boxes, rows) waits for the
// one before, and every crossed block is 5 KB of rows from the L2 (the scene,
// a few tens of MB, sits there; nothing is "streamed" as on the TPU, where
// the blocks do not fit the fast memory and a (block x ray-tile) grid carries
// the running minimum). For a pool wavefront (2048 rays) the latency of that
// chain bounds it, for a tile's primary rays (131072) the row traffic. With
// one thread per ray a warp walked the union of its 32 rays' blocks at one
// or two live lanes, and a pool wavefront filled 16 thread blocks of the
// card's 132 SMs.
//
// Design: a warp owns a ray, 4 warps per thread block, so 2048 rays are 2048
// warps and the SMs hide one warp's loads behind the others. The lanes
// split the work of their ray at every level (rt_common.cuh::
// rt_warp_blocks): 32 superboxes per step, then the boxes of the crossed
// superblocks, then the rows of each crossed block, two per lane at B = 64
// (any B; a superblock of more than 32 blocks in rounds of 32 lanes, the
// WIDE build, chosen at launch).
// No lane diverges from its warp. A block's rows reach the lanes through
// shared memory (rt_stage_rows: cp.async, consecutive lanes copying
// consecutive 16-byte words), because a lane that loads its own 128-byte row
// makes every load instruction touch 32 cache lines. Where rays are many a
// warp owns 8 consecutive rays: it walks the blocks that any of them
// crosses, stages a block's rows once and tests them against the rays that
// cross it (a warp-uniform choice), which divides the L2 traffic of
// neighbouring rays by up to 8. Each lane keeps its own best (t, slot) per
// ray; the warp's best t (one `redux` per block) is the limit of every
// later box test, and one lexicographic minimum at the end gives the plain
// scan's tie rule exactly. Rays are read as given, (R, 3). The gate is
// widened (rt_common.cuh), so the result equals the ungated plain twin bit
// for bit. Static shared memory: 20 KB of staged rows and 1.5 KB of ray
// records per thread block at 8 rays per warp.
#include "rt_common.cuh"

namespace {

template <int K, bool WIDE>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) cast_triangles_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int R,
    const float* __restrict__ pack, int B, const float* __restrict__ aabb,
    const float* __restrict__ saabb, const int* __restrict__ sb_start, int nsb, int sb_shift,
    int backface, float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float s_rays[RT_WARPS][K * RT_RAY];
  __shared__ float4 s_stage[RT_WARPS][RT_STAGE_ROWS * RT_ROW4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * RT_WARPS + warp) * K;
  if (r0 >= R) return;  // by whole warps: the shuffles below need all 32 lanes
  float* rays = s_rays[warp];
  if (lane < K && r0 + lane < R) rt_ray_record(rays + lane * RT_RAY, o, d, r0 + lane);
  __syncwarp();
  const unsigned alive = (r0 + K <= R) ? (1u << K) - 1u : (1u << (R - r0)) - 1u;

  float lane_t[K], best_t[K];
  int lane_idx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lane_t[k] = best_t[k] = RT_INF;
    lane_idx[k] = 0x7fffffff;
  }
  unsigned stale = 0;  // rays whose best t shrank since the boxes were tested
  rt_warp_blocks<K, WIDE>(
      aabb, saabb, sb_start, nsb, sb_shift, nullptr, lane, rays, alive,
      [&](int k) { return best_t[k]; },
      [&](int b, unsigned who, float, bool first) {
        if (first) stale = 0;
        rt_warp_cast_block<K>(pack, aabb, b, B, 0, lane, rays, who, backface != 0, lane_t,
                              lane_idx, best_t, &stale, s_stage[warp]);
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

template <int K>
void launch(const float* o, const float* d, int R, const float* pack, int B,
            const float* aabb, const float* saabb, const int* sb_start, int nsb, int sb_shift,
            int backface, float* t_out, int* idx_out, cudaStream_t stream) {
  const int per_block = RT_WARPS * K;
  RT_BOOL_SWITCH(sb_shift > 5, WIDE,  // superblocks of more than 32 blocks
                 cast_triangles_stream_kernel<K, WIDE>
                 <<<(R + per_block - 1) / per_block, 32 * RT_WARPS, 0, stream>>>(
                     o, d, R, pack, B, aabb, saabb, sb_start, nsb, sb_shift, backface, t_out,
                     idx_out));
}

}  // namespace

// rays_per_warp: 1 or 8
extern "C" int rt_cast_triangles_stream(const float* o, const float* d, int R,
                                        const float* pack, int nb, int B, const float* aabb,
                                        const float* saabb, const int* sb_start, int nsb,
                                        int sb_shift, int rays_per_warp, int backface,
                                        float* t_out, int* idx_out, void* stream) {
  (void)nb;
  if (rays_per_warp != 1 && rays_per_warp != 8) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    if (rays_per_warp == 8)
      launch<8>(o, d, R, pack, B, aabb, saabb, sb_start, nsb, sb_shift, backface, t_out,
                idx_out, (cudaStream_t)stream);
    else
      launch<1>(o, d, R, pack, B, aabb, saabb, sb_start, nsb, sb_shift, backface, t_out,
                idx_out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
