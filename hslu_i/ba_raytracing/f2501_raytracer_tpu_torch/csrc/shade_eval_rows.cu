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
// plus a mask. A disabled child type writes zero rows and false masks. The
// body is rt_node.cuh::rt_node_rays, as in shade_eval.cu, so the two give
// the same bits on the same inputs.
//
// What bounds it on this card: operations. Each (ray, light, triangle)
// shadow pair costs ~40-70 f32 operations; inputs and outputs are ~200 B
// per ray. At 1080p semesterbild (5 lights, 9 spheres, 48 big triangles,
// 2 blocks of 64) a lit ray tests up to ~1100 pairs. The path sends it a
// tile's primary rays (R = 131072, 16 launches per frame) and, 2496 times
// per frame, a pool wavefront of W = 2048 rays: with one thread per ray that
// was 16 thread blocks on 132 SMs, and a ray's time one thread's chain of up
// to ~1100 dependent pair tests.
//
// Design: one kernel template, its form chosen by the ray and light counts
// (kernels.node_form). Below PACKET_MIN_RAYS (a wavefront) a warp owns
// a ray, 4 warps per thread block; lane 0 holds its surface and light sums.
// For each light in order, a lit ray (cos_in > 0) writes its shadow ray,
// and the lanes share the shadow scan (rt_light.cuh::rt_warp_shadow_scan):
// spheres one per lane, the big rows (staged once per thread block, 80
// bytes a row) two per lane, the crossed Morton blocks through the
// lanes-parallel box gate, their rows split over the lanes; transmissive
// hits are added in the one-thread order by ballot and shuffle, and an
// opaque hit ends the scan. tri_blk_pack has no superboxes of its own (the
// scene's follow the cast order), so each block is a superblock of its own:
// the gate tests 32 boxes a step; a block whose row count is no multiple of
// 32 takes the RAGGED build of the row scan. Each visit copies the block's rows into
// the warp's stage (staging the 1080p scene's whole pack per thread block
// instead was 10% faster at W and is left out: a second path for no gain
// a frame can show). From PACKET_MIN_RAYS on (a tile's coherent primary
// rays) a warp takes 32 rays, a ray per lane, each lane scanning its ray's
// shadows alone (rt_light.cuh::rt_shadow_scan; the lanes walk the same rows
// at once: broadcasts; eight
// rays per warp with the lanes over rows took twice as long there). In
// both forms the lighting math of a light and the node epilogue
// (rt_node.cuh) run on the lane that owns the ray, unchanged. The form with
// a warp per ray walks a ray's lights one after another, each a chain of
// small shared scans; with many lights that chain sets the time (140
// lights at W = 3584: 0.71 ms a call on an H100, 2% of the bound; 0.16 ms in
// the form below). So a wavefront with kernels.LIGHT_LANES_MIN_LIGHTS lights
// or more takes the light-lanes form (RT_LIGHT_LANES;
// rt_node.cuh::rt_node_light_lanes): a warp still owns a ray, but its lanes
// take the ray's lights, each scanning its light's shadow ray alone over the
// one-thread tables; the lights' terms meet in shared memory and are added
// in light order by six lanes, one a channel, with the one-lane loop's
// arithmetic, so the sums keep its bits. A ray without a hit costs its
// warp one load. In every form the child rows leave through shared memory,
// 4 lanes per 64-byte row. Shared memory per thread block: in the warp form
// P * 80 B of big rows, 20 KB of block stage and 0.3 KB of ray records,
// sums and rows; a ray per lane: the one-thread tables (a few KB) and 16 KB
// of rows; light lanes: the tables, 7 KB of terms and 0.5 KB of rows.
#include "rt_node.cuh"

namespace {

struct Out {
  const int* pix;
  float *contrib, *rfl_rows, *rfr_rows;
  unsigned char *rfl_m, *rfr_m;
};

// A child's pool row into 4 float4 of shared memory (zeros when disabled)
__device__ __forceinline__ void child_row(float4* dst, bool on, const Child& c,
                                          float from_refl, float pixf) {
  if (!on) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[0] = dst[1] = dst[2] = dst[3] = z;
    return;
  }
  dst[0] = make_float4(c.o[0], c.o[1], c.o[2], c.d[0]);
  dst[1] = make_float4(c.d[1], c.d[2], c.w[0], c.w[1]);
  dst[2] = make_float4(c.w[2], c.ior, (float)c.budget, from_refl);
  dst[3] = make_float4(pixf, 0.0f, 0.0f, 0.0f);
}

// K: the form (rt_node.cuh), 1, 32 or RT_LIGHT_LANES
template <int K, bool RAGGED, bool GATED>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) shade_eval_rows_kernel(ShadeScene sc,
                                                                           WarpGate g,
                                                                           NodeParams p,
                                                                           Out out) {
  constexpr int RAYS = K == 32 ? 32 : 1;  // a warp's rays
  extern __shared__ float4 s_dyn[];
  __shared__ NodeWarpShared<K> s_warp[RT_WARPS];
  __shared__ float4 s_rows[RT_WARPS][RAYS * 8];  // per ray: reflection row, refraction row
  const Tables tb = rt_node_stage<K>(sc, s_dyn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * RT_WARPS + warp) * RAYS;
  if (r0 >= p.R) return;  // by whole warps: the shuffles below need all 32 lanes
  auto store = [&](int r, const float* contrib, const Child& rfl, const Child& rfr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out.contrib[3 * r + k] = contrib[k];
    const float pixf = (float)out.pix[r];
    child_row(s_rows[warp] + lane * 8, p.reflections, rfl, 1.0f, pixf);
    child_row(s_rows[warp] + lane * 8 + 4, p.refractions, rfr, 0.0f, pixf);
    out.rfl_m[r] = p.reflections ? rfl.mask : 0;
    out.rfr_m[r] = p.refractions ? rfr.mask : 0;
  };
  if constexpr (K == RT_LIGHT_LANES) {
    rt_node_light_lanes<GATED>(sc, tb, p, lane, r0, s_warp[warp], store);
  } else {
    const int r = r0 + lane;
    rt_node_rays<K, RAGGED, GATED>(sc, tb, g, s_dyn, p, lane, (lane < K && r < p.R) ? r : -1,
                                   s_warp[warp], store);
  }
  __syncwarp();  // the rows are in shared memory
  const int n = min(RAYS, p.R - r0);  // the warp's rays: 4n float4 per child
  for (int i = lane; i < 8 * n; i += 32) {
    const int child = i / (4 * n), j = i % (4 * n);
    float* rows = child ? out.rfr_rows : out.rfl_rows;
    reinterpret_cast<float4*>(rows + (size_t)r0 * 16)[j] = s_rows[warp][(j >> 2) * 8 + child * 4 + (j & 3)];
  }
}

template <int K, bool RAGGED>
void launch(const ShadeScene& sc, const WarpGate& g, const NodeParams& p, const Out& out,
            cudaStream_t stream) {
  const int per_block = RT_WARPS * (K == 32 ? 32 : 1);
  RT_BOOL_SWITCH(rt_gated(sc), GATED,
                 shade_eval_rows_kernel<K, RAGGED, GATED>
                 <<<(p.R + per_block - 1) / per_block, 32 * RT_WARPS, rt_node_dyn_bytes(sc, K),
                    stream>>>(sc, g, p, out));
}

}  // namespace

// order, prime: the switches (rt_light.cuh; null and 0: off); blk_saabb,
// sb_start, nsb, sb_shift: the superblocks of the gate over blk_aabb;
// form: 1 (a warp per ray), 32 (a ray per lane) or RT_LIGHT_LANES (a warp
// per ray, its lights over the lanes)
extern "C" int rt_shade_eval_rows(
    const float* lights, int n_lights, const float* sph, int S, const float* trb, int P,
    int trans_rows, const float* blk, const float* blk_aabb, int nb, int B,
    int n_trans_blocks, const int* order, int prime, const float* blk_saabb,
    const int* sb_start, int nsb, int sb_shift, int form, const float* point, const float* normal, const float* view,
    const float* color, const float* shin, const float* valid, const float* t,
    const float* w, const float* rior, const int* budget, const float* frefl,
    const float* httr, const float* met, const float* hior, const float* opac,
    const float* boost, const int* pix, int R, float eps, int backface, int reflections,
    int refractions, int refl_max, int refr_max, float weight_cutoff, float air,
    float* contrib, float* rfl_rows, unsigned char* rfl_m, float* rfr_rows,
    unsigned char* rfr_m, void* stream) {
  if (form != 1 && form != 32 && form != RT_LIGHT_LANES) return (int)cudaErrorInvalidValue;
  if (sb_shift != 0) return (int)cudaErrorInvalidValue;  // a superblock per block
  ShadeScene sc;
  NodeParams p;
  rt_fill_node(&sc, &p, lights, n_lights, sph, S, trb, P, trans_rows, blk, blk_aabb, nb, B,
               n_trans_blocks, point, normal, view, color, shin, valid, t, w, rior, budget,
               frefl, httr, met, hior, opac, boost, R, eps, backface, reflections,
               refractions, refl_max, refr_max, weight_cutoff, air, order, prime);
  const WarpGate g = {blk_saabb, sb_start, nsb, sb_shift};
  const Out out = {pix, contrib, rfl_rows, rfr_rows, rfl_m, rfr_m};
  if (R > 0) {
    if (form == 32)  // the one-thread scan: any B
      launch<32, false>(sc, g, p, out, (cudaStream_t)stream);
    else if (form == RT_LIGHT_LANES)
      launch<RT_LIGHT_LANES, false>(sc, g, p, out, (cudaStream_t)stream);
    else if (B % 32)
      launch<1, true>(sc, g, p, out, (cudaStream_t)stream);
    else
      launch<1, false>(sc, g, p, out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
