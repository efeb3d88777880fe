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
// superblock is skipped when the segment [0, maxd] misses its box
// (tri_saabb), a block when it misses its own (tri_aabb). The shadow
// Fresnel runs only on blocks whose `block_httr` entry is non-zero. Each
// pack's partial sums are added to the ray's total in order. Outputs dec
// (R,) f32, opq (R,) bool, fsub (R,3) f32 row-major. `opq` is exact; `dec`
// and `fsub` are specified where `opq` is false (the scan stops at the
// first opaque hit). A ray with maxd <= 0 or NaN hits nothing.
//
// What bounds it on this card: operations: ~45-70 f32 operations per (ray,
// triangle) pair, P pairs per ray before the first gate; inputs and outputs
// are 45 B per ray. With one thread per ray and every row read from global
// memory, a pool's width of shadow rays (10,240) was 80 thread blocks on
// 132 SMs, each thread one long chain of dependent pair tests.
//
// Design: one kernel template, its form chosen by the ray count
// (kernels.rays_per_warp), as cast_triangles.cu chooses its own. The big
// rows are staged once per thread block in shared memory, 80 bytes a row
// (rt_common.cuh: RT_ROW4 words). Below PACKET_MIN_RAYS a warp owns a ray,
// 4 warps per thread block: lane l tests big rows l, l + 32, ...
// (rt_occlude.cuh::occl_warp_rows), then the lanes share the two-level box
// gate (rt_common.cuh::rt_warp_blocks) and the rows of each crossed block
// (occl_warp_block), staged per warp. From PACKET_MIN_RAYS on (coherent
// light-major rays) a warp takes 32 rays, a ray per lane: the one-thread
// scan over the staged big rows, which every lane reads at once, and the
// blocks' rows through the L1, each lane with its own gates and its own
// early exit (on an H100, eight rays per warp with the lanes over the rows
// took 1.1-2.5x as long on three of four scenes, and 0.6-0.85x on a cloud
// of 235 blocks, where a ray crosses ~12 of them: utils/ab.py forms).
// Hits are added in storage order (in the warp form the hit rows of a round
// walked from the lowest slot by ballot and shuffle, each pack's partial
// sums then into the total): no atomics and no tree, so the sums are the
// bits of the one-thread scan in both forms and on every run. Any block
// partition: WIDE (superblocks of more than 32 blocks) and RAGGED (a row
// count no multiple of 32) are builds of the warp form, chosen at launch,
// so that the usual partition keeps its registers. Rays are read as given,
// (R, 3). Shared memory: P * 80 B of big rows; in the warp form also 20 KB
// of staged block rows, and 48 B of ray record and 32 B of sums per warp.
#include "rt_occlude.cuh"

namespace {

// A ray per lane (K = 32): the one-thread scan of ray r. The big rows come
// from the stage (floats 20-24 of a transmissive hit from `trb`), the
// blocks' rows through the L1 (rt_occlude.cuh::occl_blocks).
__device__ __forceinline__ void lane_occl(int r, const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ maxd, const float4* big,
                                          const float* __restrict__ trb, int P, bool trans_big,
                                          const float* __restrict__ pack, int B,
                                          const float* __restrict__ aabb,
                                          const float* __restrict__ saabb,
                                          const int* __restrict__ sb_start, int nsb,
                                          const float* __restrict__ block_httr, bool bf,
                                          float* __restrict__ dec, unsigned char* __restrict__ opq,
                                          float* __restrict__ fsub) {
  Occl tot = {0.0f, 0.0f, 0.0f, 0.0f, false};
  const float md = maxd[r];
  if (md > 0.0f) {
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    // big primitives (walls, floors): never culled; occl_tri's arithmetic
    Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
    for (int c = 0; c < P; ++c) {
      float w[4 * RT_ROW4];
      rt_staged_row(big, c, w);
      float t;
      bool valid = rt_tri_test(w, ox, oy, oz, dx, dy, dz, &t);
      const bool httr = w[14] != 0.0f;
      const float cos_nv = -rt_dot_normal(w, dx, dy, dz);
      if (bf) valid = valid && ((-cos_nv < 0.75f) || httr);
      if (!(valid && t <= md)) continue;
      if (!httr) {  // opaque: the sums of an occluded ray are not read
        part.opq = true;
        break;
      }
      float m[8];  // row floats 20-27: metallic, colour r, absorption
      rt_load4<2>(trb + c * 32 + 20, m);
      float io = 0.0f;
      if (trans_big) io = w[19] * rt_shadow_tr_red(cos_nv, w[18], m[0], m[1], true);
      part.dec += 1.0f - io;
      part.fr += m[2];
      part.fg += m[3];
      part.fb += m[4];
    }
    add_part(&tot, part);
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    bool done = tot.opq;
    for (int g = 0; g < nsb && !done; ++g) {
      const int b0 = sb_start[g], b1 = sb_start[g + 1];
      if (b1 - b0 > 1 && !rt_gate(saabb + g * 8, ox, oy, oz, ix, iy, iz, md)) continue;
      done = occl_blocks(pack, aabb, block_httr, b0, b1, B, ox, oy, oz, dx, dy, dz, ix, iy, iz,
                         md, bf, &tot);
    }
  }
  occl_store(tot, r, dec, opq, fsub);
}

// K consecutive rays from r0 for one warp (K = 1: a warp per ray): the big
// rows, then the crossed blocks, each pack's partial sums into the totals
// in `sums` (see the note above). All 32 lanes.
template <int K, bool RAGGED, bool WIDE>
__device__ __forceinline__ void warp_occl(int r0, int lane, const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ maxd, int R, const float4* big,
                                          const float* __restrict__ trb, int P, bool trans_big,
                                          const float* __restrict__ pack, int B,
                                          const float* __restrict__ aabb,
                                          const float* __restrict__ saabb,
                                          const int* __restrict__ sb_start, int nsb, int sb_shift,
                                          const float* __restrict__ block_httr, bool bf,
                                          float* rays, float* sums, float4* stage,
                                          float* __restrict__ dec,
                                          unsigned char* __restrict__ opq_out,
                                          float* __restrict__ fsub) {
  const int r = r0 + lane;
  bool can_hit = false;  // max distance <= 0 or NaN: zeros
  if (lane < K && r < R) {
    const float md = maxd[r];
    can_hit = md > 0.0f;
    rt_ray_record(rays + lane * RT_RAY, o, d, r);
    rays[lane * RT_RAY + 9] = md;
#pragma unroll
    for (int i = 0; i < 4; ++i) sums[lane * OCCL_SUMS + i] = 0.0f;
  }
  unsigned alive = __ballot_sync(RT_WARP, can_hit), opq = 0;
  __syncwarp();  // the ray records are written
  if (alive) {  // big primitives: never culled
    unsigned who = alive, touched = 0;
    occl_warp_rows<K, true>(big, trb, P, trans_big ? P : 0, lane, rays, sums, &who, bf, &alive,
                            &opq, &touched);
    occl_warp_fold<K>(sums, lane, touched);
  }
  rt_warp_blocks<K, WIDE>(
      aabb, saabb, sb_start, nsb, sb_shift, block_httr, lane, rays, alive,
      [&](int k) { return rays[k * RT_RAY + 9]; },
      [&](int b, unsigned who, float httr, bool) {
        occl_warp_block<K, RAGGED>(pack + (size_t)b * B * 32, B, lane, rays, sums, who, bf,
                                   httr != 0.0f, &alive, &opq, stage);
      });
  if (lane < K && r < R) {
    const float* tot = sums + lane * OCCL_SUMS;
    const Occl mine = {tot[0], tot[1], tot[2], tot[3], (opq >> lane & 1u) != 0};
    occl_store(mine, r, dec, opq_out, fsub);
  }
}

template <int K, bool RAGGED, bool WIDE>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) occlude_triangles_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ maxd, int R, const float* __restrict__ trb, int P,
    int bigtri_trans, const float* __restrict__ pack, int B, const float* __restrict__ aabb,
    const float* __restrict__ saabb, const int* __restrict__ sb_start, int nsb, int sb_shift,
    const float* __restrict__ block_httr, int backface, float* __restrict__ dec,
    unsigned char* __restrict__ opq, float* __restrict__ fsub) {
  constexpr bool per_lane = K == 32;
  extern __shared__ float4 s_big[];  // P rows of RT_ROW4 words
  __shared__ float s_rays[RT_WARPS][per_lane ? 1 : K * RT_RAY];
  __shared__ float s_sums[RT_WARPS][per_lane ? 1 : K * OCCL_SUMS];
  __shared__ float4 s_stage[RT_WARPS][per_lane ? 1 : RT_STAGE_ROWS * RT_ROW4];
  rt_stage_block_rows(s_big, trb, P);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * RT_WARPS + warp) * K;
  if constexpr (per_lane) {
    if (r0 + lane < R)
      lane_occl(r0 + lane, o, d, maxd, s_big, trb, P, bigtri_trans != 0, pack, B, aabb, saabb,
                sb_start, nsb, block_httr, backface != 0, dec, opq, fsub);
  } else {
    if (r0 >= R) return;  // by whole warps: the shuffles below need all 32 lanes
    warp_occl<K, RAGGED, WIDE>(r0, lane, o, d, maxd, R, s_big, trb, P, bigtri_trans != 0, pack,
                               B, aabb, saabb, sb_start, nsb, sb_shift, block_httr,
                               backface != 0, s_rays[warp], s_sums[warp], s_stage[warp], dec,
                               opq, fsub);
  }
}

template <int K, bool RAGGED, bool WIDE>
void launch(const float* o, const float* d, const float* maxd, int R, const float* trb, int P,
            int bigtri_trans, const float* pack, int B, const float* aabb, const float* saabb,
            const int* sb_start, int nsb, int sb_shift, const float* block_httr, int backface,
            float* dec, unsigned char* opq, float* fsub, cudaStream_t stream) {
  const int per_block = RT_WARPS * K;
  occlude_triangles_kernel<K, RAGGED, WIDE><<<(R + per_block - 1) / per_block, 32 * RT_WARPS,
                                              sizeof(float4) * RT_ROW4 * P, stream>>>(
      o, d, maxd, R, trb, P, bigtri_trans, pack, B, aabb, saabb, sb_start, nsb, sb_shift,
      block_httr, backface, dec, opq, fsub);
}

}  // namespace

// rays_per_warp: 1 or 32 (a ray per lane)
extern "C" int rt_occlude_triangles(const float* o, const float* d, const float* maxd, int R,
                                    const float* trb, int P, int bigtri_trans,
                                    const float* pack, int nb, int B, const float* aabb,
                                    const float* saabb, const int* sb_start, int nsb,
                                    int sb_shift, int rays_per_warp, const float* block_httr,
                                    int backface, float* dec, unsigned char* opq, float* fsub,
                                    void* stream) {
  (void)nb;
  if (rays_per_warp != 1 && rays_per_warp != 32) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (rays_per_warp == 32)  // the one-thread scan: any partition
      launch<32, false, false>(o, d, maxd, R, trb, P, bigtri_trans, pack, B, aabb, saabb,
                               sb_start, nsb, sb_shift, block_httr, backface, dec, opq, fsub, s);
    else  // RAGGED: a ragged last round of rows in every block; WIDE: superblocks of more than 32
      RT_BOOL_SWITCH(B % 32 != 0, RAGGED, RT_BOOL_SWITCH(sb_shift > 5, WIDE,
          launch<1, RAGGED, WIDE>(o, d, maxd, R, trb, P, bigtri_trans, pack, B, aabb, saabb,
                                  sb_start, nsb, sb_shift, block_httr, backface, dec, opq, fsub,
                                  s)));
  }
  return (int)cudaGetLastError();
}
