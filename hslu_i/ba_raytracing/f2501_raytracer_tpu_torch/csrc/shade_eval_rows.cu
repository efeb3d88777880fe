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
// bits are those of shade_eval.cu (one thread per ray) on the same inputs.
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
// Design: one kernel template, its form chosen by the ray count
// (kernels.rays_per_warp). Below PACKET_MIN_RAYS (a wavefront) a warp owns
// a ray, 4 warps per thread block; lane 0 holds its surface and light sums.
// For each light in order, a lit ray (cos_in > 0) writes its shadow ray,
// and the lanes share the shadow scan (rt_light.cuh::rt_warp_shadow_scan):
// spheres one per lane, the big rows (staged once per thread block, 80
// bytes a row) two per lane, the crossed Morton blocks through the
// lanes-parallel box gate, their rows split over the lanes; transmissive
// hits are added in the one-thread order by ballot and shuffle, and an
// opaque hit ends the scan. tri_blk_pack has no superboxes of its own (the
// scene's follow the cast order), so each block is a superblock of its own:
// the gate tests 32 boxes a step. Each visit copies the block's rows into
// the warp's stage (staging the 1080p scene's whole pack per thread block
// instead was 10% faster at W and is left out: a second path for no gain
// a frame can show). From PACKET_MIN_RAYS on (a tile's
// coherent primary rays) a warp takes 32 rays, a ray per lane, each lane
// scanning its ray's shadows alone with the one-thread code of light_shade
// and shade_eval (the lanes walk the same rows at once: broadcasts; eight
// rays per warp with the lanes over rows took twice as long there). In
// every form the lighting math of a light and the node epilogue
// (rt_node.cuh) run on the lane that owns the ray, unchanged, and the child
// rows leave through shared memory, 4 lanes per 64-byte row. Shared memory
// per thread block: in the warp form P * 80 B of big rows, 20 KB of block
// stage and 0.3 KB of ray records, sums and rows; a ray per lane: the
// one-thread tables (a few KB) and 16 KB of rows.
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

template <int K>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) shade_eval_rows_kernel(ShadeScene sc,
                                                                           bool staged,
                                                                           WarpGate g,
                                                                           NodeParams p,
                                                                           Out out) {
  constexpr bool per_lane = K == 32;
  extern __shared__ float4 s_dyn[];
  __shared__ float s_rays[RT_WARPS][per_lane ? 1 : K * RT_RAY];
  __shared__ float s_sums[RT_WARPS][per_lane ? 1 : K * OCCL_SUMS];
  __shared__ float4 s_stage[RT_WARPS][per_lane ? 1 : RT_STAGE_ROWS * RT_ROW4];
  __shared__ float4 s_rows[RT_WARPS][K * 8];  // per ray: reflection row, refraction row
  // a ray per lane reads the one-thread scan's tables (rt_light.cuh); the
  // warp forms the big rows in the 80-byte layout
  Tables tb = {sc.lights, sc.sph, sc.trb};
  if constexpr (per_lane)
    tb = rt_stage_tables(sc, staged, reinterpret_cast<float*>(s_dyn));
  else
    rt_stage_block_rows(s_dyn, sc.trb, sc.P);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * RT_WARPS + warp) * K;
  if (r0 >= p.R) return;  // by whole warps: the shuffles below need all 32 lanes
  float* rays = s_rays[warp];
  float* sums = s_sums[warp];
  const int r = r0 + lane;
  const bool mine = lane < K && r < p.R;  // this lane owns ray r

  Surf s;
  s.hval = false;
  float shin = 0.0f;
  if (mine) {
    s = rt_surf(p, r);
    shin = p.shin[r];
  }
  const bool has_spec = shin > 0.0f;
  const float spec_exp = fmaxf(shin * 512.0f, 1.0f);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // direct, specular
  for (int l = 0; l < sc.n_lights; ++l) {
    const float* L = tb.lights + l * 8;
    LightRay q;
    bool lit = false;
    if (s.hval) {
      q = rt_light_ray(L, p.eps, s.px, s.py, s.pz, s.nx, s.ny, s.nz);
      lit = q.cos_in > 0.0f;  // else intensity and color are exactly 0
    }
    Occl occ = {0.0f, 0.0f, 0.0f, 0.0f, true};  // can_reach is false: the light adds nothing
    if constexpr (per_lane) {
      if (lit) occ = rt_shadow_scan(sc, tb, q.sox, q.soy, q.soz, q.ldx, q.ldy, q.ldz, q.maxd);
    } else {
      if (lit) {
        float* rec = rays + lane * RT_RAY;
        rec[0] = q.sox, rec[1] = q.soy, rec[2] = q.soz;
        rec[3] = q.ldx, rec[4] = q.ldy, rec[5] = q.ldz;
        rec[6] = 1.0f / q.ldx, rec[7] = 1.0f / q.ldy, rec[8] = 1.0f / q.ldz;
        rec[9] = q.maxd;
      }
      const unsigned need = __ballot_sync(RT_WARP, lit);  // bit k: ray k
      if (!need) continue;
      __syncwarp();  // the records are written
      const unsigned opq = rt_warp_shadow_scan<K>(sc, g, s_dyn, lane, rays, sums, need,
                                                  s_stage[warp]);
      if (lit) {
        const float* tot = sums + lane * OCCL_SUMS;
        occ = Occl{tot[0], tot[1], tot[2], tot[3], (opq >> lane & 1u) != 0};
      }
      __syncwarp();  // the sums are read before the next light's scan writes them
    }
    if (!occ.opq)
      rt_light_add(L, q, occ.dec, occ.fr, occ.fg, occ.fb, s.nx, s.ny, s.nz, s.dx, s.dy, s.dz,
                   s.mcr, s.mcg, s.mcb, has_spec, spec_exp, acc);
  }

  if (mine) {
    float contrib[3];
    Child rfl, rfr;
    rt_node_epilogue(p, r, s, acc, acc + 3, contrib, &rfl, &rfr);
#pragma unroll
    for (int k = 0; k < 3; ++k) out.contrib[3 * r + k] = contrib[k];
    const float pixf = (float)out.pix[r];
    child_row(s_rows[warp] + lane * 8, p.reflections, rfl, 1.0f, pixf);
    child_row(s_rows[warp] + lane * 8 + 4, p.refractions, rfr, 0.0f, pixf);
    out.rfl_m[r] = p.reflections ? rfl.mask : 0;
    out.rfr_m[r] = p.refractions ? rfr.mask : 0;
  }
  __syncwarp();  // the rows are in shared memory
  const int n = min(K, p.R - r0);  // the warp's rays: 4n float4 per child
  for (int i = lane; i < 8 * n; i += 32) {
    const int child = i / (4 * n), j = i % (4 * n);
    float* rows = child ? out.rfr_rows : out.rfl_rows;
    reinterpret_cast<float4*>(rows + (size_t)r0 * 16)[j] = s_rows[warp][(j >> 2) * 8 + child * 4 + (j & 3)];
  }
}

template <int K>
void launch(const ShadeScene& sc, const WarpGate& g, const NodeParams& p, const Out& out,
            cudaStream_t stream) {
  const int per_block = RT_WARPS * K;
  const bool staged = rt_tables_fit(sc);  // the one-thread tables of a ray per lane
  const size_t smem = K == 32 ? (staged ? rt_table_bytes(sc) : 0) : sizeof(float4) * RT_ROW4 * sc.P;
  shade_eval_rows_kernel<K><<<(p.R + per_block - 1) / per_block, 32 * RT_WARPS, smem, stream>>>(
      sc, staged, g, p, out);
}

}  // namespace

// blk_saabb, sb_start, nsb, sb_shift: the superblocks of the gate over
// blk_aabb; rays_per_warp: 1 or 32 (a ray per lane)
extern "C" int rt_shade_eval_rows(
    const float* lights, int n_lights, const float* sph, int S, const float* trb, int P,
    int trans_rows, const float* blk, const float* blk_aabb, int nb, int B,
    int n_trans_blocks, const float* blk_saabb, const int* sb_start, int nsb, int sb_shift,
    int rays_per_warp, const float* point, const float* normal, const float* view,
    const float* color, const float* shin, const float* valid, const float* t,
    const float* w, const float* rior, const int* budget, const float* frefl,
    const float* httr, const float* met, const float* hior, const float* opac,
    const float* boost, const int* pix, int R, float eps, int backface, int reflections,
    int refractions, int refl_max, int refr_max, float weight_cutoff, float air,
    float* contrib, float* rfl_rows, unsigned char* rfl_m, float* rfr_rows,
    unsigned char* rfr_m, void* stream) {
  if (rays_per_warp != 1 && rays_per_warp != 32) return (int)cudaErrorInvalidValue;
  ShadeScene sc;
  NodeParams p;
  rt_fill_node(&sc, &p, lights, n_lights, sph, S, trb, P, trans_rows, blk, blk_aabb, nb, B,
               n_trans_blocks, point, normal, view, color, shin, valid, t, w, rior, budget,
               frefl, httr, met, hior, opac, boost, R, eps, backface, reflections,
               refractions, refl_max, refr_max, weight_cutoff, air);
  const WarpGate g = {blk_saabb, sb_start, nsb, sb_shift};
  const Out out = {pix, contrib, rfl_rows, rfr_rows, rfl_m, rfr_m};
  if (R > 0) {
    if (rays_per_warp == 32)
      launch<32>(sc, g, p, out, (cudaStream_t)stream);
    else
      launch<1>(sc, g, p, out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
