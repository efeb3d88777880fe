// Fused shading + shading-tree node evaluation with per-field outputs, for
// the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_shade_eval_kernel(packed_rows=False)` (line 1858) behind
//   `pallas_shade_eval` (line 2115). It serves the per-ray stack path
//   (tiles below kernel_ray_tile * compaction_ratio, or compaction_ratio 1)
//   and the pool path with packed_stage=False.
//
// What it computes, per ray: the node of rt_node.cuh, the same body as
// shade_eval_rows.cu. Outputs, each row-major: contrib (R,3); reflection
// child o, d, w (R,3), budget (R,) int32, mask (R,) bool; refraction child
// o, d, w (R,3), budget (R,) int32, ior (R,), mask (R,) bool. A disabled
// child type writes zeros and false masks (refraction ior 1), as the TPU
// kernel does. The reflection child's medium and both children's
// from_refl flags are not outputs: the caller knows them.
//
// What bounds it on this card: operations, as shade_eval_rows.cu (the
// shadow scan: ~40-70 f32 operations per (ray, light, triangle) pair,
// ~200 B of inputs and outputs per ray).
//
// Design: one thread per ray; small tables in shared memory when they fit;
// Morton blocks from global memory behind the widened gate; the exact early
// exits of rt_light.cuh.
#include "rt_node.cuh"

namespace {

struct Out {
  float *contrib;
  float *rfl_o, *rfl_d, *rfl_w;
  int* rfl_b;
  unsigned char* rfl_m;
  float *rfr_o, *rfr_d, *rfr_w;
  int* rfr_b;
  float* rfr_i;
  unsigned char* rfr_m;
};

__device__ __forceinline__ void store3(float* dst, int r, const float* v) {
  dst[3 * r] = v[0];
  dst[3 * r + 1] = v[1];
  dst[3 * r + 2] = v[2];
}

__global__ void shade_eval_kernel(ShadeScene sc, bool staged, NodeParams p, Out out) {
  extern __shared__ float smem[];
  const Tables tb = rt_stage_tables(sc, staged, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;

  float contrib[3];
  Child rfl, rfr;
  rt_eval_node(sc, tb, p, r, contrib, &rfl, &rfr);
  store3(out.contrib, r, contrib);
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  if (p.reflections) {
    store3(out.rfl_o, r, rfl.o);
    store3(out.rfl_d, r, rfl.d);
    store3(out.rfl_w, r, rfl.w);
    out.rfl_b[r] = rfl.budget;
    out.rfl_m[r] = rfl.mask;
  } else {
    store3(out.rfl_o, r, zero3);
    store3(out.rfl_d, r, zero3);
    store3(out.rfl_w, r, zero3);
    out.rfl_b[r] = 0;
    out.rfl_m[r] = 0;
  }
  if (p.refractions) {
    store3(out.rfr_o, r, rfr.o);
    store3(out.rfr_d, r, rfr.d);
    store3(out.rfr_w, r, rfr.w);
    out.rfr_b[r] = rfr.budget;
    out.rfr_i[r] = rfr.ior;
    out.rfr_m[r] = rfr.mask;
  } else {
    store3(out.rfr_o, r, zero3);
    store3(out.rfr_d, r, zero3);
    store3(out.rfr_w, r, zero3);
    out.rfr_b[r] = 0;
    out.rfr_i[r] = 1.0f;
    out.rfr_m[r] = 0;
  }
}

}  // namespace

extern "C" int rt_shade_eval(
    const float* lights, int n_lights, const float* sph, int S, const float* trb, int P,
    int trans_rows, const float* blk, const float* blk_aabb, int nb, int B,
    int n_trans_blocks, const float* point, const float* normal, const float* view,
    const float* color, const float* shin, const float* valid, const float* t,
    const float* w, const float* rior, const int* budget, const float* frefl,
    const float* httr, const float* met, const float* hior, const float* opac,
    const float* boost, int R, float eps, int backface, int reflections, int refractions,
    int refl_max, int refr_max, float weight_cutoff, float air, float* contrib,
    float* rfl_o, float* rfl_d, float* rfl_w, int* rfl_b, unsigned char* rfl_m,
    float* rfr_o, float* rfr_d, float* rfr_w, int* rfr_b, float* rfr_i,
    unsigned char* rfr_m, void* stream) {
  ShadeScene sc;
  NodeParams p;
  rt_fill_node(&sc, &p, lights, n_lights, sph, S, trb, P, trans_rows, blk, blk_aabb, nb, B,
               n_trans_blocks, point, normal, view, color, shin, valid, t, w, rior, budget,
               frefl, httr, met, hior, opac, boost, R, eps, backface, reflections,
               refractions, refl_max, refr_max, weight_cutoff, air);
  const Out out = {contrib, rfl_o, rfl_d, rfl_w, rfl_b, rfl_m,
                   rfr_o, rfr_d, rfr_w, rfr_b, rfr_i, rfr_m};
  const bool staged = rt_tables_fit(sc);
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    shade_eval_kernel<<<blocks, threads, staged ? rt_table_bytes(sc) : 0,
                        (cudaStream_t)stream>>>(sc, staged, p, out);
  }
  return (int)cudaGetLastError();
}
