// Shadow sums over the Morton blocks of a scene past `stream_triangles`,
// for the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_occl_stream_kernel` (line 604) behind
//   `pallas_occlude_triangles_stream` (line 719). ops/intersect.py::
//   occlude_rays takes it when `scene.streaming`: it is the lighting path of
//   streamed scenes (ops/shading.py::calculate_lighting sends R*C shadow
//   rays per light chunk). Spheres and the big-primitive pack stay plain
//   PyTorch there.
//
// What it computes, per shadow ray (o, d, maxd), over the Morton blocks of
// tri_cast_pack in storage order: rt_occlude.cuh's sums `dec`, `opq`,
// `fsub` over the hits with t <= maxd. The shadow Fresnel runs only on
// blocks whose entry of `block_httr` (nb,) is non-zero. Outputs dec (R,)
// f32, opq (R,) bool, fsub (R,3) f32 row-major. `opq` is exact; `dec` and
// `fsub` are specified where `opq` is false (the scan stops at the first
// opaque hit, and no caller reads the sums of an occluded ray). A ray with
// maxd <= 0 (a parked lane, a light behind the surface) hits nothing: t >
// eps and t <= maxd cannot both hold.
//
// What bounds it on this card: operations, as cast_triangles_stream.cu: the
// boxes of all nb blocks per ray, then ~45-70 f32 operations per triangle
// of every block the segment crosses.
//
// Design: one thread per ray, blocks in order, partial sums per block added
// to the ray's total as the plain twin adds them. No atomics and no
// cross-thread reduction: the same bits on every run.
#include "rt_occlude.cuh"

namespace {

__global__ void occlude_triangles_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ maxd, int R, const float* __restrict__ pack, int nb, int B,
    const float* __restrict__ aabb, const float* __restrict__ block_httr, int backface,
    float* __restrict__ dec, unsigned char* __restrict__ opq, float* __restrict__ fsub) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Occl tot = {0.0f, 0.0f, 0.0f, 0.0f, false};
  const float md = maxd[r];
  if (md > 0.0f) {
    const float ox = o[r], oy = o[R + r], oz = o[2 * R + r];
    const float dx = d[r], dy = d[R + r], dz = d[2 * R + r];
    occl_blocks(pack, aabb, block_httr, 0, nb, B, ox, oy, oz, dx, dy, dz, 1.0f / dx,
                1.0f / dy, 1.0f / dz, md, backface != 0, &tot);
  }
  occl_store(tot, r, dec, opq, fsub);
}

}  // namespace

extern "C" int rt_occlude_triangles_stream(const float* o, const float* d, const float* maxd,
                                           int R, const float* pack, int nb, int B,
                                           const float* aabb, const float* block_httr,
                                           int backface, float* dec, unsigned char* opq,
                                           float* fsub, void* stream) {
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    occlude_triangles_stream_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        o, d, maxd, R, pack, nb, B, aabb, block_httr, backface, dec, opq, fsub);
  }
  return (int)cudaGetLastError();
}
