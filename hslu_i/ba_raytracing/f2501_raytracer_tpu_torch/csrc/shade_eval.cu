// Fused shading + shading-tree node evaluation with per-field outputs, for
// the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_shade_eval_kernel(packed_rows=False)` (line 1858) behind
//   `pallas_shade_eval` (line 2115). It serves the per-ray stack path
//   (tiles below kernel_ray_tile * compaction_ratio, or compaction_ratio 1)
//   and the pool path with packed_stage=False.
//
// What it computes, per ray: the node of rt_node.cuh, the body of
// shade_eval_rows.cu (rt_node_rays), so the two give the same bits on the
// same inputs. Outputs, each row-major: contrib (R,3); reflection child o, d,
// w (R,3), budget (R,) int32, mask (R,) bool; refraction child o, d, w
// (R,3), budget (R,) int32, ior (R,), mask (R,) bool. A disabled child type
// writes zeros and false masks (refraction ior 1), as the TPU kernel does.
// The reflection child's medium and both children's from_refl flags are not
// outputs: the caller knows them.
//
// What bounds it on this card: operations, as shade_eval_rows.cu (the
// shadow scan: ~40-70 f32 operations per (ray, light, triangle) pair), but
// only for the rays that hit. The stack path sends it all R = 131072 slots
// of a tile on every iteration; after the first few, only reflected and
// refracted rays are live, scattered over the slots. With one thread per
// slot, a warp that held one live ray ran that ray's whole chain of
// dependent pair tests while its other 31 lanes idled. The unpacked pool
// sends it W = 512 rays: 4 thread blocks of one thread per ray on 132 SMs.
//
// Design: four launches, with no host synchronisation between them and no
// atomics.
//   1. live_slots_kernel, one thread per slot: each segment of 128 slots
//      writes the indices of its slots whose ray hit (valid != 0), in slot
//      order (a ballot per warp), to its part of the live list, and their
//      count; every other slot gets its outputs at once: no light reaches
//      it, so its node is the epilogue alone (rt_node_unlit).
//   2. scan_counts_kernel, one thread block: the counts, in place, into the
//      segments' offsets in the list of live rays, and the live count.
//   3. shade_eval_warp_kernel: up to `warp_max_live` live rays
//      (kernels.NODE_WARP_MAX_LIVE, measured on the card) a warp takes a ray
//      of the list at a time (its segment found by a binary search of the
//      offsets), its lanes sharing the ray's shadow scans, on a grid of as
//      many thread blocks as the card runs at once.
//   4. shade_eval_lane_kernel: beyond that count, a thread block per
//      segment, a ray per lane over the segment's live slots (neighbouring
//      pixels); thread blocks of empty segments leave at once. The card's
//      scheduler places each thread block as one ends: a grid of as many
//      thread blocks as the card holds, with fixed shares of the list and a
//      scan in each, was 10% slower at 114,847 live rays.
// Shared memory as shade_eval_rows.cu, without its rows; the offsets stay
// in global memory, so any R fits. Scratch (from the wrapper): the live
// list and the segments' counts, then offsets, and the live count, R +
// ceil(R / 128) + 1 int32.
#include <algorithm>

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

// Ray r's node into the per-field outputs; a disabled child type writes
// zeros, a false mask and (refraction) ior 1
__device__ __forceinline__ void store_node(const NodeParams& p, const Out& out, int r,
                                           const float* contrib, const Child& rfl,
                                           const Child& rfr) {
  const bool a = p.reflections, b = p.refractions;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.contrib[3 * r + k] = contrib[k];
    out.rfl_o[3 * r + k] = a ? rfl.o[k] : 0.0f;
    out.rfl_d[3 * r + k] = a ? rfl.d[k] : 0.0f;
    out.rfl_w[3 * r + k] = a ? rfl.w[k] : 0.0f;
    out.rfr_o[3 * r + k] = b ? rfr.o[k] : 0.0f;
    out.rfr_d[3 * r + k] = b ? rfr.d[k] : 0.0f;
    out.rfr_w[3 * r + k] = b ? rfr.w[k] : 0.0f;
  }
  out.rfl_b[r] = a ? rfl.budget : 0;
  out.rfl_m[r] = a ? rfl.mask : 0;
  out.rfr_b[r] = b ? rfr.budget : 0;
  out.rfr_i[r] = b ? rfr.ior : 1.0f;
  out.rfr_m[r] = b ? rfr.mask : 0;
}

#define SEG 128  // slots per segment of the live list: one thread block of the ray-per-lane form

// Launch 1: per segment of SEG slots, its live slots in order at the
// segment's start in `live` and their count in counts[segment]; the outputs
// of the other slots.
__global__ void __launch_bounds__(SEG) live_slots_kernel(NodeParams p, Out out,
                                                         int* __restrict__ live,
                                                         int* __restrict__ counts) {
  __shared__ int s_off[SEG / 32];  // live slots of the warps before
  const int r = blockIdx.x * SEG + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = r < p.R;
  const bool hit = in && p.valid[r] != 0.0f;
  const unsigned ballot = __ballot_sync(RT_WARP, hit);
  if (lane == 0) s_off[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < SEG / 32; ++w) {
      const int c = s_off[w];
      s_off[w] = n;
      n += c;
    }
    counts[blockIdx.x] = n;
  }
  __syncthreads();
  if (hit) {
    live[blockIdx.x * SEG + s_off[warp] + __popc(ballot & ((1u << lane) - 1u))] = r;
  } else if (in) {
    rt_node_unlit(p, r, [&](int i, const float* contrib, const Child& rfl, const Child& rfr) {
      store_node(p, out, i, contrib, rfl, rfr);
    });
  }
}

#define SCAN_THREADS 1024

// Launch 2: counts[0, nseg) in place into their exclusive prefix sums (the
// offsets of the segments' parts in the live list), and the live count
// into counts[nseg]. One thread block, SCAN_THREADS segments a round.
__global__ void __launch_bounds__(SCAN_THREADS) scan_counts_kernel(int* __restrict__ counts,
                                                                   int nseg) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;  // the live slots of the rounds before
  for (int k0 = 0; k0 < nseg; k0 += SCAN_THREADS) {
    const int k = k0 + threadIdx.x;
    const int mine = k < nseg ? counts[k] : 0;
    int incl = mine;  // inclusive prefix over the warp's lanes
    for (int dist = 1; dist < 32; dist <<= 1) {
      const int up = __shfl_up_sync(RT_WARP, incl, dist);
      if (lane >= dist) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = carry, round = 0;
    for (int w = 0; w < SCAN_THREADS / 32; ++w) {
      if (w < warp) before += s_warp[w];
      round += s_warp[w];
    }
    if (k < nseg) counts[k] = before + incl - mine;
    carry += round;
    __syncthreads();  // s_warp is read before the next round writes it
  }
  if (threadIdx.x == 0) counts[nseg] = carry;
}

// The slot of entry i (< offsets[nseg]) of the live list
__device__ __forceinline__ int live_slot(const int* __restrict__ live,
                                         const int* __restrict__ offsets, int nseg, int i) {
  int lo = 0, hi = nseg - 1;  // the last segment s with offsets[s] <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offsets + mid) <= i) lo = mid;
    else hi = mid - 1;
  }
  return live[lo * SEG + (i - __ldg(offsets + lo))];
}

// Launch 3: the form with a warp per ray. If the live rays are no more than
// `warp_max_live`, the list's entries are dealt to the grid's warps in turn.
template <bool RAGGED>
__global__ void __launch_bounds__(32 * RT_WARPS, 2) shade_eval_warp_kernel(
    ShadeScene sc, WarpGate g, NodeParams p, Out out, const int* __restrict__ live,
    const int* __restrict__ offsets, int nseg, int warp_max_live) {
  extern __shared__ float4 s_dyn[];
  __shared__ NodeWarpShared<1> s_warp[RT_WARPS];
  const int n = offsets[nseg];
  if (n > warp_max_live) return;  // the other form's count: the whole grid
  const Tables tb = rt_node_stage<1>(sc, s_dyn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto store = [&](int r, const float* contrib, const Child& rfl, const Child& rfr) {
    store_node(p, out, r, contrib, rfl, rfr);
  };
  for (int i = blockIdx.x * RT_WARPS + warp; i < n; i += gridDim.x * RT_WARPS)
    rt_node_rays<1, RAGGED>(sc, tb, g, s_dyn, p, lane,
                            lane == 0 ? live_slot(live, offsets, nseg, i) : -1, s_warp[warp],
                            store);
}

// Launch 4: the form with a ray per lane, if the live rays are more than
// `warp_max_live`: thread block s takes the live slots of segment s, a ray
// per lane, in slot order (neighbouring pixels).
__global__ void __launch_bounds__(SEG, 2) shade_eval_lane_kernel(
    ShadeScene sc, WarpGate g, NodeParams p, Out out, const int* __restrict__ live,
    const int* __restrict__ offsets, int nseg, int warp_max_live) {
  extern __shared__ float4 s_dyn[];
  __shared__ NodeWarpShared<32> s_warp[SEG / 32];
  const int n = offsets[blockIdx.x + 1] - offsets[blockIdx.x];
  if (offsets[nseg] <= warp_max_live || n == 0) return;  // whole thread blocks
  const Tables tb = rt_node_stage<32>(sc, s_dyn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto store = [&](int r, const float* contrib, const Child& rfl, const Child& rfr) {
    store_node(p, out, r, contrib, rfl, rfr);
  };
  if (warp * 32 >= n) return;  // by whole warps
  const int i = threadIdx.x;
  rt_node_rays<32, false>(sc, tb, g, s_dyn, p, lane, i < n ? live[blockIdx.x * SEG + i] : -1,
                          s_warp[warp], store);
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <bool RAGGED>
void launch_warp_form(const ShadeScene& sc, const WarpGate& g, const NodeParams& p,
                      const Out& out, const int* live, const int* offsets, int nseg,
                      int warp_max_live, cudaStream_t stream) {
  const size_t smem = rt_node_dyn_bytes(sc, 1);
  int per_sm = 0;  // as many thread blocks as the card runs at once
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shade_eval_warp_kernel<RAGGED>,
                                                32 * RT_WARPS, smem);
  const int blocks = std::max(1, std::min((p.R + RT_WARPS - 1) / RT_WARPS, per_sm * sm_count()));
  shade_eval_warp_kernel<RAGGED><<<blocks, 32 * RT_WARPS, smem, stream>>>(
      sc, g, p, out, live, offsets, nseg, warp_max_live);
}

}  // namespace

// blk_saabb, sb_start, nsb, sb_shift: the superblocks of the gate over
// blk_aabb (a superblock per block: sb_shift 0); warp_max_live: the most live rays the
// form with a warp per ray takes; scratch: R + ceil(R / 128) + 1 int32 of
// device memory
extern "C" int rt_shade_eval(
    const float* lights, int n_lights, const float* sph, int S, const float* trb, int P,
    int trans_rows, const float* blk, const float* blk_aabb, int nb, int B,
    int n_trans_blocks, const float* blk_saabb, const int* sb_start, int nsb, int sb_shift,
    int warp_max_live, const float* point, const float* normal, const float* view,
    const float* color, const float* shin, const float* valid, const float* t,
    const float* w, const float* rior, const int* budget, const float* frefl,
    const float* httr, const float* met, const float* hior, const float* opac,
    const float* boost, int R, float eps, int backface, int reflections, int refractions,
    int refl_max, int refr_max, float weight_cutoff, float air, int* scratch, float* contrib,
    float* rfl_o, float* rfl_d, float* rfl_w, int* rfl_b, unsigned char* rfl_m,
    float* rfr_o, float* rfr_d, float* rfr_w, int* rfr_b, float* rfr_i,
    unsigned char* rfr_m, void* stream) {
  if (sb_shift != 0) return (int)cudaErrorInvalidValue;
  ShadeScene sc;
  NodeParams p;
  rt_fill_node(&sc, &p, lights, n_lights, sph, S, trb, P, trans_rows, blk, blk_aabb, nb, B,
               n_trans_blocks, point, normal, view, color, shin, valid, t, w, rior, budget,
               frefl, httr, met, hior, opac, boost, R, eps, backface, reflections,
               refractions, refl_max, refr_max, weight_cutoff, air);
  const WarpGate g = {blk_saabb, sb_start, nsb, sb_shift};
  const Out out = {contrib, rfl_o, rfl_d, rfl_w, rfl_b, rfl_m,
                   rfr_o, rfr_d, rfr_w, rfr_b, rfr_i, rfr_m};
  if (R > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int nseg = (R + SEG - 1) / SEG;
    int* live = scratch;
    int* offsets = scratch + R;  // the counts, then (launch 2) their offsets
    live_slots_kernel<<<nseg, SEG, 0, s>>>(p, out, live, offsets);
    scan_counts_kernel<<<1, SCAN_THREADS, 0, s>>>(offsets, nseg);
    RT_BOOL_SWITCH(B % 32 != 0, RAGGED,
                   launch_warp_form<RAGGED>(sc, g, p, out, live, offsets, nseg, warp_max_live,
                                            s));
    shade_eval_lane_kernel<<<nseg, SEG, rt_node_dyn_bytes(sc, 32), s>>>(
        sc, g, p, out, live, offsets, nseg, warp_max_live);  // the lanes: any B
  }
  return (int)cudaGetLastError();
}
