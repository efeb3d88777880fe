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
// block with an opaque hit, and no caller reads the sums of an occluded
// ray). A ray with maxd <= 0 or NaN (a parked lane, a light behind the
// surface) hits nothing and leaves at once with zeros: t > eps and
// t <= maxd cannot both hold.
//
// What bounds it on this card: as cast_triangles_stream.cu. A shadow ray
// crosses a few blocks of ~45-70 f32 operations per triangle. The pool sends
// only 10,240 rays at a time: there the latency of dependent loads bounds
// it, and with one thread per ray those were 80 thread blocks whose warps
// walked the union of their rays' blocks at one or two live lanes. A tile's
// primary node sends 655,360: there the L2 traffic of the rows bounds it.
//
// Design: a warp owns a ray (10,240 rays: 2560 thread blocks of 4 warps) or,
// where rays are many, 8 consecutive rays that share each block's loads.
// The lanes share the two-level box gate (rt_common.cuh::rt_warp_blocks)
// and the rows of each crossed block (rt_occlude.cuh::occl_warp_block),
// which reach them through shared memory (rt_common.cuh::rt_stage_rows).
// The sums stay in storage order: the hit rows of a block (rare) are walked
// from the lowest slot by ballot and shuffle, and each block's partial sums
// are added to the ray's total. No atomics and no tree over f32 sums: the
// bits are those of a one-thread scan, on every run. Any block partition:
// superblocks of more than 32 blocks go in rounds of 32 lanes (the WIDE
// build), and blocks whose row count is no multiple of 32 take the RAGGED
// build of the row scan; each is chosen at launch, so that the usual
// partition keeps its registers. Rays are read as given, (R, 3). Static
// shared memory: 20 KB of staged rows, 1.5 KB of ray records and 1 KB of
// sums per thread block at 8 rays per warp.
#include "rt_occlude.cuh"

namespace {

template <int K, bool RAGGED, bool WIDE>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) occlude_triangles_stream_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ maxd, int R, const float* __restrict__ pack, int B,
    const float* __restrict__ aabb, const float* __restrict__ saabb,
    const int* __restrict__ sb_start, int nsb, int sb_shift,
    const float* __restrict__ block_httr, int backface, float* __restrict__ dec,
    unsigned char* __restrict__ opq_out, float* __restrict__ fsub) {
  __shared__ float s_rays[RT_WARPS][K * RT_RAY];
  __shared__ float s_sums[RT_WARPS][K * OCCL_SUMS];
  __shared__ float4 s_stage[RT_WARPS][RT_STAGE_ROWS * RT_ROW4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * RT_WARPS + warp) * K;
  if (r0 >= R) return;  // by whole warps: the shuffles below need all 32 lanes
  float* rays = s_rays[warp];
  float* sums = s_sums[warp];
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
  rt_warp_blocks<K, WIDE>(
      aabb, saabb, sb_start, nsb, sb_shift, block_httr, lane, rays, alive,
      [&](int k) { return rays[k * RT_RAY + 9]; },
      [&](int b, unsigned who, float httr, bool) {
        occl_warp_block<K, RAGGED>(pack + (size_t)b * B * 32, B, lane, rays, sums, who,
                                   backface != 0, httr != 0.0f, &alive, &opq, s_stage[warp]);
      });
  if (lane < K && r < R) {
    const float* tot = sums + lane * OCCL_SUMS;
    const Occl mine = {tot[0], tot[1], tot[2], tot[3], (opq >> lane & 1u) != 0};
    occl_store(mine, r, dec, opq_out, fsub);
  }
}

template <int K>
void launch(const float* o, const float* d, const float* maxd, int R, const float* pack, int B,
            const float* aabb, const float* saabb, const int* sb_start, int nsb, int sb_shift,
            const float* block_httr, int backface, float* dec, unsigned char* opq, float* fsub,
            cudaStream_t stream) {
  const int per_block = RT_WARPS * K;
  // RAGGED: a ragged last round of rows in every block; WIDE: superblocks of
  // more than 32 blocks
  RT_BOOL_SWITCH(B % 32 != 0, RAGGED, RT_BOOL_SWITCH(sb_shift > 5, WIDE,
      occlude_triangles_stream_kernel<K, RAGGED, WIDE>
      <<<(R + per_block - 1) / per_block, 32 * RT_WARPS, 0, stream>>>(
          o, d, maxd, R, pack, B, aabb, saabb, sb_start, nsb, sb_shift, block_httr, backface,
          dec, opq, fsub)));
}

}  // namespace

// rays_per_warp: 1 or 8
extern "C" int rt_occlude_triangles_stream(const float* o, const float* d, const float* maxd,
                                           int R, const float* pack, int nb, int B,
                                           const float* aabb, const float* saabb,
                                           const int* sb_start, int nsb, int sb_shift,
                                           int rays_per_warp, const float* block_httr,
                                           int backface, float* dec, unsigned char* opq,
                                           float* fsub, void* stream) {
  (void)nb;
  if (rays_per_warp != 1 && rays_per_warp != 8) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    if (rays_per_warp == 8)
      launch<8>(o, d, maxd, R, pack, B, aabb, saabb, sb_start, nsb, sb_shift, block_httr,
                backface, dec, opq, fsub, (cudaStream_t)stream);
    else
      launch<1>(o, d, maxd, R, pack, B, aabb, saabb, sb_start, nsb, sb_shift, block_httr,
                backface, dec, opq, fsub, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
