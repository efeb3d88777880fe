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
// t = +inf, idx = 2^31-1. Superblocks (sb_start) and blocks are skipped by
// the AABB slab gate against the ray's own current best t.
//
// What bounds it on this card: operations. Each (ray, triangle) pair costs
// ~40 f32 operations and one divide; the inputs are 24 B per ray and a few
// KB of scene, so bytes are negligible. The semesterbild scene at 1080p has
// P = 48 and nb = 2 blocks of 64, ~180 pairs per ray before gating.
//
// Design: one thread per ray, rays in SoA (3, R) so loads coalesce. Every
// thread of a warp walks the same triangle rows at the same time, so a row
// load is one broadcast transaction (L1-resident; the scene is not staged
// in shared memory, so scenes of any size work). The gate is per thread
// (a warp-level vote would only change which threads idle). The gate box is
// widened by a tiny margin (rt_common.cuh) so it never culls a block that
// holds a nearer hit: the result equals the ungated plain twin exactly.
#include "rt_common.cuh"

namespace {

__global__ void cast_triangles_kernel(const float* __restrict__ o,
                                      const float* __restrict__ d, int R,
                                      const float* __restrict__ trb, int P,
                                      const float* __restrict__ pack, int nb, int B,
                                      const float* __restrict__ aabb,
                                      const float* __restrict__ saabb,
                                      const int* __restrict__ sb_start, int nsb,
                                      int backface, float* __restrict__ t_out,
                                      int* __restrict__ idx_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[r], oy = o[R + r], oz = o[2 * R + r];
  const float dx = d[r], dy = d[R + r], dz = d[2 * R + r];

  float best_t = RT_INF;
  int best_idx = 0x7fffffff;

  // big primitives: walls / floors, never culled
  for (int p = 0; p < P; ++p) {
    const float* w = trb + p * 32;
    float t;
    bool valid = rt_tri_test(w, ox, oy, oz, dx, dy, dz, &t);
    if (backface) valid = valid && ((rt_dot_normal(w, dx, dy, dz) < 0.75f) || (w[14] != 0.0f));
    if (valid && t < best_t) {
      best_t = t;
      best_idx = p;
    }
  }

  // Morton blocks, front to back, behind superblock and block gates
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  for (int g = 0; g < nsb; ++g) {
    const int b0 = sb_start[g], b1 = sb_start[g + 1];
    if (b1 - b0 > 1 && !rt_gate(saabb + g * 8, ox, oy, oz, ix, iy, iz, best_t)) continue;
    rt_cast_blocks(pack, aabb, b0, b1, B, P, ox, oy, oz, dx, dy, dz, ix, iy, iz, backface != 0,
                   &best_t, &best_idx);
  }
  t_out[r] = best_t;
  idx_out[r] = best_idx;
}

}  // namespace

extern "C" int rt_cast_triangles(const float* o, const float* d, int R, const float* trb,
                                 int P, const float* pack, int nb, int B,
                                 const float* aabb, const float* saabb,
                                 const int* sb_start, int nsb, int backface, float* t_out,
                                 int* idx_out, void* stream) {
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    cast_triangles_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        o, d, R, trb, P, pack, nb, B, aabb, saabb, sb_start, nsb, backface, t_out,
        idx_out);
  }
  return (int)cudaGetLastError();
}
