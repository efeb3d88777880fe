// Direct + specular lighting with hard shadows, for the PyTorch port
// (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_light_shade_kernel` (line 1834) behind `pallas_light_shade` (line
//   2368). It serves every config without reflections or refractions
//   (`default`, `anti_aliasing`, `soft_shadows`) through
//   ops/shading.py::calculate_lighting.
//
// What it computes, per ray: direct and specular sums over the first
// n_lights lights, WITHOUT ambient (the caller adds it, as the JAX package
// does; ops/shading.py::light_sums): per light the shadow ray and its scan
// of rt_light.cuh, then that light's terms. Inputs: point, normal, view,
// color (R,3) f32; shininess, valid (R,) f32 (valid: 1.0 / 0.0). Outputs:
// direct, spec (R,3) f32, row-major.
//
// What bounds it on this card: operations. Each (ray, light, triangle)
// shadow pair costs ~40-70 f32 operations; inputs and outputs are 80 B per
// ray. Soft shadows multiply the lights by 10 (50 at 1080p semesterbild),
// so the scan, not memory, sets the time. It runs at a tile's R = 131072
// primary rays: with one thread per ray looping over its lights, a ray was
// one thread's chain of up to 50 shadow scans, and 131072 threads of 69
// registers were ~1.1 waves of the card.
//
// Design: the work is split by (ray, light). A thread block holds 32
// consecutive rays and `warps` warps; an item is the run of 32 rays and one
// light, and the warps take the lights of a chunk in turn, each lane
// scanning the shadow ray of its ray to that light alone (rt_shadow_scan:
// the lanes head for one light from neighbouring points, so they walk the
// same rows and mostly leave together). With 5 lights a tile is 20,480
// items on 4096 thread blocks of 5 warps, where the one-thread loop had
// 1024 thread blocks of 4 warps, each lane 5 scans in a row. Each item's
// shadow sums (dec, fr, fg, fb, opq) go to shared memory, 32 lanes apart.
// Then warp 0, whose lane l owns ray l, walks the chunk's lights in order
// with the one-thread loop's arithmetic (rt_light_ray, rt_light_add) and
// skips exactly the lights it skips (behind the surface, or occluded), so
// the sums are added in the same order and have the same bits. A chunk is
// at most LS_LIGHTS lights, so that the sums stay small (10 KB) and the SM
// holds many thread blocks; the launch picks the warps that leave the
// fewest idle in a chunk's rounds (block_warps: 5 at 5 lights, 8 at 50). The small
// tables (lights in use, spheres, big primitives) are staged in shared
// memory where they fit 48 KB, the Morton rows are read through the L1
// (staging the 1080p stand-in's 16 KB pack per thread block was 3% faster
// at 5 lights and 0.7% slower at 50, and is left out). Rays are
// bound-checked, so R need not be a multiple of 32.
#include <algorithm>

#include "rt_light.cuh"

namespace {

#define LS_MAX_WARPS 8  // warps per thread block, at most
#define LS_LIGHTS 16    // lights per chunk
#define LS_SUMS 5       // shadow sums per (ray, light): dec, fr, fg, fb, opq

__device__ __forceinline__ LightRay ray_to(const float* L, float eps, int r,
                                           const float* __restrict__ point,
                                           const float* __restrict__ normal) {
  return rt_light_ray(L, eps, point[3 * r], point[3 * r + 1], point[3 * r + 2], normal[3 * r],
                      normal[3 * r + 1], normal[3 * r + 2]);
}

// With this bound ptxas keeps 48 registers and spills 12 bytes; without it
// (66 registers, no spill) fewer thread blocks fit an SM, and the kernel ran
// about 7% slower at 5 and at 50 lights on an H100, each build timed in turns
// with the one-thread kernel it replaced.
__global__ void __launch_bounds__(32 * LS_MAX_WARPS) light_shade_kernel(
    ShadeScene sc, bool staged, float eps, int R,
    const float* __restrict__ point, const float* __restrict__ normal,
    const float* __restrict__ view, const float* __restrict__ color,
    const float* __restrict__ shin, const float* __restrict__ valid, float* __restrict__ direct,
    float* __restrict__ spec) {
  extern __shared__ float smem[];
  const Tables tb = rt_stage_tables(sc, staged, smem);
  float* sums = smem + (staged ? rt_table_bytes(sc) / sizeof(float) : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int r = blockIdx.x * 32 + lane;  // every warp's lane l: ray l of the block
  const bool hval = r < R && valid[r] != 0.0f;
  const int chunk = min(LS_LIGHTS, sc.n_lights);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // direct, specular
  for (int l0 = 0; l0 < sc.n_lights; l0 += chunk) {
    const int lc = min(chunk, sc.n_lights - l0);
    for (int l = warp; l < lc; l += warps) {
      Occl occ = {0.0f, 0.0f, 0.0f, 0.0f, true};
      if (hval) {
        const LightRay q = ray_to(tb.lights + (l0 + l) * 8, eps, r, point, normal);
        if (q.cos_in > 0.0f)  // else intensity and color are exactly 0: no scan
          occ = rt_shadow_scan(sc, tb, q.sox, q.soy, q.soz, q.ldx, q.ldy, q.ldz, q.maxd);
      }
      float* dst = sums + l * LS_SUMS * 32 + lane;
      dst[0] = occ.dec;
      dst[32] = occ.fr;
      dst[64] = occ.fg;
      dst[96] = occ.fb;
      dst[128] = occ.opq ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (warp == 0 && hval) {  // the one-thread light loop over this chunk, in light order
      const float nx = normal[3 * r], ny = normal[3 * r + 1], nz = normal[3 * r + 2];
      const float sh = shin[r];
      const bool has_spec = sh > 0.0f;
      const float spec_exp = fmaxf(sh * 512.0f, 1.0f);
      for (int l = 0; l < lc; ++l) {
        const float* L = tb.lights + (l0 + l) * 8;
        const LightRay q = ray_to(L, eps, r, point, normal);
        if (!(q.cos_in > 0.0f)) continue;
        const float* src = sums + l * LS_SUMS * 32 + lane;
        if (src[128] != 0.0f) continue;  // can_reach is false: the light adds nothing
        rt_light_add(L, q, src[0], src[32], src[64], src[96], nx, ny, nz, view[3 * r],
                     view[3 * r + 1], view[3 * r + 2], color[3 * r], color[3 * r + 1],
                     color[3 * r + 2], has_spec, spec_exp, acc);
      }
    }
    __syncthreads();  // the sums are read before the next chunk writes them
  }
  if (warp == 0 && r < R) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      direct[3 * r + k] = acc[k];
      spec[3 * r + k] = acc[3 + k];
    }
  }
}

// Warps of a thread block, one light each at a time: of 4 to LS_MAX_WARPS
// (fewer with fewer lights), the count whose rounds over a chunk leave the
// fewest warps idle, the most warps of those
int block_warps(int n_lights) {
  const int chunk = std::max(1, std::min(n_lights, LS_LIGHTS));
  int best = 0, least_idle = 0;
  for (int w = std::min(chunk, LS_MAX_WARPS); w >= std::min(chunk, 4); --w) {
    const int idle = (chunk + w - 1) / w * w - chunk;
    if (best == 0 || idle < least_idle) best = w, least_idle = idle;
  }
  return best;
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
  const size_t smem = (staged ? rt_table_bytes(sc) : 0) +
                      sizeof(float) * std::min(n_lights, LS_LIGHTS) * LS_SUMS * 32;
  if (R > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        light_shade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    light_shade_kernel<<<(R + 31) / 32, 32 * block_warps(n_lights), smem,
                         (cudaStream_t)stream>>>(
        sc, staged, eps, R, point, normal, view, color, shin, valid, direct, spec);
  }
  return (int)cudaGetLastError();
}
