// Shadow sums over the big-primitive pack and the Morton blocks of a
// resident scene, for the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_occlude_kernel` (line 964; bodies `_bigtri_occl_comp` 250 and
//   `_tri_occl_comp` 871) behind `pallas_occlude_triangles` (line 996).
//   ops/intersect.py::occlude_rays takes it for a scene that is not
//   streamed; the spheres stay plain PyTorch there. No render path calls
//   `occlude_rays` on a resident scene in either package (lighting goes
//   through the fused light kernels): it is the package's stand-alone
//   occlusion query.
//
// What it computes, per shadow ray (o, d, maxd): rt_occlude.cuh's sums
// `dec`, `opq`, `fsub` over the hits with t <= maxd, first over the P rows
// of trb_pack (shadow Fresnel only if `bigtri_trans`), then over the Morton
// blocks of tri_cast_pack in storage order under the two-level gate: a
// superblock of more than one block is skipped when the segment [0, maxd]
// misses its box (tri_saabb), a block when it misses its own (tri_aabb).
// The shadow Fresnel runs only on blocks whose `block_httr` entry is
// non-zero. Outputs dec (R,) f32, opq (R,) bool, fsub (R,3) f32 row-major.
// `opq` is exact; `dec` and `fsub` are specified where `opq` is false (the
// scan stops at the first opaque hit). A ray with maxd <= 0 hits nothing.
//
// What bounds it on this card: operations: ~45-70 f32 operations per (ray,
// triangle) pair, P pairs per ray before the first gate; inputs and outputs
// are 45 B per ray.
//
// Design: one thread per ray, packs in order, each pack's partial sums
// added to the ray's total as the plain twin adds them; no atomics, so the
// same bits on every run. Rays in SoA (3, R) so their loads coalesce; every
// thread of a warp reads the same triangle row at the same time (one
// broadcast transaction).
#include "rt_occlude.cuh"

namespace {

__global__ void occlude_triangles_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ maxd, int R, const float* __restrict__ trb, int P,
    int bigtri_trans, const float* __restrict__ pack, int nb, int B,
    const float* __restrict__ aabb, const float* __restrict__ saabb,
    const int* __restrict__ sb_start, int nsb, const float* __restrict__ block_httr,
    int backface, float* __restrict__ dec, unsigned char* __restrict__ opq,
    float* __restrict__ fsub) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Occl tot = {0.0f, 0.0f, 0.0f, 0.0f, false};
  const float md = maxd[r];
  if (md > 0.0f) {
    const float ox = o[r], oy = o[R + r], oz = o[2 * R + r];
    const float dx = d[r], dy = d[R + r], dz = d[2 * R + r];
    const bool bf = backface != 0;
    // big primitives: walls / floors, never culled
    bool done = occl_pack(trb, P, ox, oy, oz, dx, dy, dz, md, bf, bigtri_trans != 0, &tot);
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    for (int g = 0; g < nsb && !done; ++g) {
      const int b0 = sb_start[g], b1 = sb_start[g + 1];
      if (b1 - b0 > 1 && !rt_gate(saabb + g * 8, ox, oy, oz, ix, iy, iz, md)) continue;
      done = occl_blocks(pack, aabb, block_httr, b0, b1, B, ox, oy, oz, dx, dy, dz, ix, iy, iz,
                         md, bf, &tot);
    }
  }
  occl_store(tot, r, dec, opq, fsub);
}

}  // namespace

extern "C" int rt_occlude_triangles(const float* o, const float* d, const float* maxd, int R,
                                    const float* trb, int P, int bigtri_trans,
                                    const float* pack, int nb, int B, const float* aabb,
                                    const float* saabb, const int* sb_start, int nsb,
                                    const float* block_httr, int backface, float* dec,
                                    unsigned char* opq, float* fsub, void* stream) {
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    occlude_triangles_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        o, d, maxd, R, trb, P, bigtri_trans, pack, nb, B, aabb, saabb, sb_start, nsb,
        block_httr, backface, dec, opq, fsub);
  }
  return (int)cudaGetLastError();
}
