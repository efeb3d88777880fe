// Fused shading + shading-tree node evaluation with packed pool rows, for
// the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_shade_eval_kernel(packed_rows=True)` (line 1858) behind
//   `pallas_shade_eval_rows` (line 2250).
//
// What it computes, per ray: the node of rt_node.cuh (ambient + direct +
// specular light over all lights with the hard-shadow scan of
// rt_light.cuh, the distance attenuation, the transmissive combine rule,
// and the reflection / refraction children), with each child written as an
// (R, 16) pool row [o3 | d3 | w3 | ior | budget | from_refl | pix | 0 0 0]
// plus a mask. A disabled child type writes zero rows and false masks.
//
// What bounds it on this card: operations. Each (ray, light, triangle)
// shadow pair costs ~40-70 f32 operations; inputs and outputs are ~200 B
// per ray. At 1080p semesterbild (5 lights, 9 spheres, 48 big triangles,
// 2 blocks of 64) a lit ray tests up to ~1100 pairs.
//
// Design: one thread per ray. The small tables (lights, spheres, big
// primitives: a few KB) are staged in shared memory when they fit; the
// Morton block pack is read from global memory (L1/L2-resident, every lane
// of a warp reads the same row), so the real text mesh (~1.9 MB of blocks)
// also works. Blocks are skipped by the widened AABB gate (rt_common.cuh),
// and the early exits of rt_light.cuh are exact.
#include "rt_node.cuh"

namespace {

struct Out {
  const int* pix;
  float *contrib, *rfl_rows, *rfr_rows;
  unsigned char *rfl_m, *rfr_m;
};

__device__ __forceinline__ void store_row(float* rows, int r, const Child& c,
                                          float from_refl, float pixf) {
  float4* dst = reinterpret_cast<float4*>(rows + (size_t)r * 16);
  dst[0] = make_float4(c.o[0], c.o[1], c.o[2], c.d[0]);
  dst[1] = make_float4(c.d[1], c.d[2], c.w[0], c.w[1]);
  dst[2] = make_float4(c.w[2], c.ior, (float)c.budget, from_refl);
  dst[3] = make_float4(pixf, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void store_zero_row(float* rows, int r) {
  float4* dst = reinterpret_cast<float4*>(rows + (size_t)r * 16);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  dst[0] = z;
  dst[1] = z;
  dst[2] = z;
  dst[3] = z;
}

__global__ void shade_eval_rows_kernel(ShadeScene sc, bool staged, NodeParams p, Out out) {
  extern __shared__ float smem[];
  const Tables tb = rt_stage_tables(sc, staged, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;

  float contrib[3];
  Child rfl, rfr;
  rt_eval_node(sc, tb, p, r, contrib, &rfl, &rfr);
#pragma unroll
  for (int k = 0; k < 3; ++k) out.contrib[3 * r + k] = contrib[k];
  const float pixf = (float)out.pix[r];
  if (p.reflections) {
    store_row(out.rfl_rows, r, rfl, 1.0f, pixf);
    out.rfl_m[r] = rfl.mask;
  } else {
    store_zero_row(out.rfl_rows, r);
    out.rfl_m[r] = 0;
  }
  if (p.refractions) {
    store_row(out.rfr_rows, r, rfr, 0.0f, pixf);
    out.rfr_m[r] = rfr.mask;
  } else {
    store_zero_row(out.rfr_rows, r);
    out.rfr_m[r] = 0;
  }
}

}  // namespace

extern "C" int rt_shade_eval_rows(
    const float* lights, int n_lights, const float* sph, int S, const float* trb, int P,
    int trans_rows, const float* blk, const float* blk_aabb, int nb, int B,
    int n_trans_blocks, const float* point, const float* normal, const float* view,
    const float* color, const float* shin, const float* valid, const float* t,
    const float* w, const float* rior, const int* budget, const float* frefl,
    const float* httr, const float* met, const float* hior, const float* opac,
    const float* boost, const int* pix, int R, float eps, int backface, int reflections,
    int refractions, int refl_max, int refr_max, float weight_cutoff, float air,
    float* contrib, float* rfl_rows, unsigned char* rfl_m, float* rfr_rows,
    unsigned char* rfr_m, void* stream) {
  ShadeScene sc;
  NodeParams p;
  rt_fill_node(&sc, &p, lights, n_lights, sph, S, trb, P, trans_rows, blk, blk_aabb, nb, B,
               n_trans_blocks, point, normal, view, color, shin, valid, t, w, rior, budget,
               frefl, httr, met, hior, opac, boost, R, eps, backface, reflections,
               refractions, refl_max, refr_max, weight_cutoff, air);
  const Out out = {pix, contrib, rfl_rows, rfr_rows, rfl_m, rfr_m};
  const bool staged = rt_tables_fit(sc);
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    shade_eval_rows_kernel<<<blocks, threads, staged ? rt_table_bytes(sc) : 0,
                             (cudaStream_t)stream>>>(sc, staged, p, out);
  }
  return (int)cudaGetLastError();
}
