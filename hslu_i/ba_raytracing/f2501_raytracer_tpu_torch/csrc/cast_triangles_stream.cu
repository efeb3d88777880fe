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
// blocks of tri_cast_pack (nb blocks of B rows, 32 floats per triangle) in
// storage order, strict `<` across candidates, so on equal t the earlier
// block and the lower slot win. Output: t (R,) and the local slot
// b*B + c (R,) int32; a miss is t = +inf, idx = 2^31-1. A block is skipped
// when the segment [0, best t so far] misses its box (tri_aabb).
//
// "Streamed" on the TPU means the blocks do not fit its fast memory and a
// (block x ray-tile) grid carries the running minimum in scratch. On this
// card the resident kernel reads global memory through L1/L2 as well, so
// the two differ only in what they scan: this one has no big-primitive pack
// and no superblock level.
//
// What bounds it on this card: operations. A scene of 200,000 triangles is
// 25.6 MB (half the L2); each ray tests the boxes of all nb blocks (~30 f32
// operations each) and the B triangles of every block it crosses (~40
// each).
//
// Design: one thread per ray walking the blocks in order, which gives the
// tie rule for free; rays in SoA (3, R) so their loads coalesce. The gate is
// per thread and widened (rt_common.cuh), so the result equals the ungated
// plain twin exactly. Threads of a warp that cross different blocks diverge:
// the warp walks the union of their blocks. At the pool's width (2048 rays)
// only 16 thread blocks exist, so most SMs idle.
#include "rt_common.cuh"

namespace {

__global__ void cast_triangles_stream_kernel(const float* __restrict__ o,
                                             const float* __restrict__ d, int R,
                                             const float* __restrict__ pack, int nb, int B,
                                             const float* __restrict__ aabb, int backface,
                                             float* __restrict__ t_out,
                                             int* __restrict__ idx_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[r], oy = o[R + r], oz = o[2 * R + r];
  const float dx = d[r], dy = d[R + r], dz = d[2 * R + r];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best_t = RT_INF;
  int best_idx = 0x7fffffff;
  rt_cast_blocks(pack, aabb, 0, nb, B, 0, ox, oy, oz, dx, dy, dz, ix, iy, iz, backface != 0,
                 &best_t, &best_idx);
  t_out[r] = best_t;
  idx_out[r] = best_idx;
}

}  // namespace

extern "C" int rt_cast_triangles_stream(const float* o, const float* d, int R,
                                        const float* pack, int nb, int B, const float* aabb,
                                        int backface, float* t_out, int* idx_out,
                                        void* stream) {
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    cast_triangles_stream_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        o, d, R, pack, nb, B, aabb, backface, t_out, idx_out);
  }
  return (int)cudaGetLastError();
}
