// Direct + specular lighting with hard shadows, for the PyTorch port
// (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_light_shade_kernel` (line 1834) behind `pallas_light_shade` (line
//   2368). It serves every config without reflections or refractions
//   (`default`, `anti_aliasing`, `soft_shadows`) through
//   ops/shading.py::calculate_lighting.
//
// What it computes, per ray: rt_light.cuh's direct and specular sums over
// the first n_lights lights, WITHOUT ambient (the caller adds it, as the
// JAX package does). Inputs: point, normal, view, color (R,3) f32;
// shininess, valid (R,) f32 (valid: 1.0 / 0.0). Outputs: direct, spec
// (R,3) f32, row-major.
//
// What bounds it on this card: operations. Each (ray, light, triangle)
// shadow pair costs ~40-70 f32 operations; inputs and outputs are 80 B per
// ray. Soft shadows multiply the lights by 10 (50 at 1080p semesterbild),
// so the scan, not memory, sets the time.
//
// Design: one thread per ray, looping over the lights in order (no 8-light
// chunks); the small tables in shared memory when the lights in use,
// spheres and big primitives fit 48 KB; Morton blocks from global memory
// behind the widened gate; the exact early exits of rt_light.cuh. Rays are
// bound-checked, so R need not be a multiple of the block size.
#include "rt_light.cuh"

namespace {

__global__ void light_shade_kernel(ShadeScene sc, bool staged, float eps, int R,
                                   const float* __restrict__ point,
                                   const float* __restrict__ normal,
                                   const float* __restrict__ view,
                                   const float* __restrict__ color,
                                   const float* __restrict__ shin,
                                   const float* __restrict__ valid, float* direct,
                                   float* spec) {
  extern __shared__ float smem[];
  const Tables tb = rt_stage_tables(sc, staged, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float dir[3], spc[3];
  rt_light_sums(sc, tb, eps, valid[r] != 0.0f, point[3 * r], point[3 * r + 1],
                point[3 * r + 2], normal[3 * r], normal[3 * r + 1], normal[3 * r + 2],
                view[3 * r], view[3 * r + 1], view[3 * r + 2], color[3 * r],
                color[3 * r + 1], color[3 * r + 2], shin[r], dir, spc);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    direct[3 * r + k] = dir[k];
    spec[3 * r + k] = spc[k];
  }
}

}  // namespace

extern "C" int rt_light_shade(const float* lights, int n_lights, const float* sph, int S,
                              const float* trb, int P, int trans_rows, const float* blk,
                              const float* blk_aabb, int nb, int B, int n_trans_blocks,
                              const float* point, const float* normal, const float* view,
                              const float* color, const float* shin, const float* valid,
                              int R, float eps, int backface, float* direct, float* spec,
                              void* stream) {
  const ShadeScene sc = {lights, sph, trb, blk, blk_aabb, n_lights, S, P, trans_rows,
                         nb, B, n_trans_blocks, backface};
  const bool staged = rt_tables_fit(sc);
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    light_shade_kernel<<<blocks, threads, staged ? rt_table_bytes(sc) : 0,
                         (cudaStream_t)stream>>>(sc, staged, eps, R, point, normal, view,
                                                 color, shin, valid, direct, spec);
  }
  return (int)cudaGetLastError();
}
