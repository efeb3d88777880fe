// The pool iteration's put, for the PyTorch port (sm_90a).
//
// Replaces: no kernel of hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py.
//   The JAX package leaves this step of `_run_pool` to XLA (its staging and
//   `_pool_append`); the port ran it as ~25 PyTorch ops and two
//   device-to-device copies a pool iteration (ops/trace.py::_pool_put,
//   _pool_append), each a node of the chunk's CUDA graph.
//
// What it computes, for one iteration of the pool loop at width W with k
// child types (the node kernel's rows and masks, in the pool-append order
// [refr, refl]), given [start, count] of the iteration's take:
// * the slot's staging rows: lane l's pixel where l < count - start, else
//   its own dump row R + slot * W + l of the accumulator; its contribution
//   where live, else 0;
// * capped = min(start, Q_cap - 2W), dropped += start - capped;
// * m = mask & (lane live) over the k * W candidate rows, and the accepted
//   row i written to pool row capped + (rank of i among the accepted); the
//   last rejected row to the dump row Q (the last write of the plain
//   scatter, which sends every rejected row there);
// * count = capped + (number accepted), in place.
// The integer scan and the copies are exact: the pool, the staging rows and
// both counts are the plain twin's bits (ops/trace.py::_pool_put).
//
// What bounds it on this card: neither. k * W rows of 64 B (0.26 MB at
// realistic's W = 2048, k = 2; 0.46 MB at extreme's W = 3584) copied once;
// what it removes is ~25 graph nodes of plain ops and two copies, each
// ~1.5 us of launch latency.
//
// Design: a thread per candidate row, 256 rows a thread block. Each block
// counts the accepted rows before its own and in all (every mask, 4-7 KB,
// read by every block: no second pass and no atomics), then ranks its rows
// by ballot and a scan over its 8 warps. The counts are read from the take,
// never from `count`, which thread 0 of block 0 rewrites.
#include "rt_common.cuh"

namespace {

#define PUT_THREADS 256

struct Cand {
  const float* rows[2];
  const unsigned char* mask[2];
  int W;
  // candidate r (child r / W, lane r % W) is accepted: its lane is live
  // (below n_live = count - start) and its mask set
  __device__ __forceinline__ bool accepted(int r, long long n_live) const {
    const int c = r >= W, l = r - c * W;
    return l < n_live && mask[c][l] != 0;
  }
  __device__ __forceinline__ const float4* row(int r) const {
    const int c = r >= W;
    return reinterpret_cast<const float4*>(rows[c] + (size_t)(r - c * W) * 16);
  }
};

// the sum of v over the thread block (all threads call it)
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(RT_WARP, v, s);
  __syncthreads();  // scratch is free
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < PUT_THREADS / 32; ++i) total += scratch[i];
  return total;
}

__global__ void __launch_bounds__(PUT_THREADS)
    pool_put_kernel(float4* __restrict__ pool, long long Q, long long Q_cap,
                    long long* __restrict__ count, long long* __restrict__ dropped,
                    long long* __restrict__ stage_pix, float* __restrict__ stage_contrib,
                    const long long* __restrict__ take, const int* __restrict__ pix,
                    const float* __restrict__ contrib, Cand cand, int k, int slot,
                    long long R) {
  __shared__ int scratch[PUT_THREADS / 32];
  const int W = cand.W, N = k * W;
  const long long start = take[0], n_live = take[1] - start;
  const int first = blockIdx.x * PUT_THREADS;

  // the accepted rows before this block's and in all
  int before = 0, all = 0;
  for (int r = threadIdx.x; r < N; r += PUT_THREADS) {
    const int a = cand.accepted(r, n_live);
    all += a;
    before += r < first ? a : 0;
  }
  before = block_sum(before, scratch);
  all = block_sum(all, scratch);

  // this row's rank among the accepted: by ballot within the warp, then
  // the warps before it
  const int r = first + threadIdx.x;
  const bool a = r < N && cand.accepted(r, n_live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(RT_WARP, a);
  __syncthreads();  // scratch is free
  if (lane == 0) scratch[warp] = __popc(ball);
  __syncthreads();
  int rank = before + __popc(ball & ((1u << lane) - 1u));
  for (int i = 0; i < warp; ++i) rank += scratch[i];

  const long long cap = Q_cap - 2LL * W;
  const long long capped = start < cap ? start : cap;
  if (r < N) {
    // the accepted row to its place; of the rejected, the last to the dump row
    long long dest = -1;
    if (a)
      dest = capped + rank;
    else if (r - rank == (N - all) - 1)
      dest = Q;
    if (dest >= 0) {
      const float4* src = cand.row(r);
#pragma unroll
      for (int i = 0; i < 4; ++i) pool[dest * 4 + i] = src[i];
    }
  }
  if (r < W) {  // the slot's staging row of lane r
    const bool live = r < n_live;
    const long long s = (long long)slot * W + r;
    stage_pix[s] = live ? (long long)pix[r] : R + s;
#pragma unroll
    for (int c = 0; c < 3; ++c) stage_contrib[3 * s + c] = live ? contrib[3 * r + c] : 0.0f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count = capped + all;
    *dropped += start - capped;
  }
}

}  // namespace

// pool (Q + 1, 16), its last row the dump row; rows_a / mask_a, rows_b /
// mask_b: the candidate rows (W, 16) and masks (W,) in the pool-append
// order, k of them (rows_b unused when k = 1); stage_pix, stage_contrib:
// the chunk's staging rows, slot `slot` written; R: the accumulator's first
// dump row
extern "C" int rt_pool_put(float* pool, long long Q, long long Q_cap, long long* count,
                           long long* dropped, long long* stage_pix, float* stage_contrib,
                           const long long* take, const int* pix, const float* contrib,
                           const float* rows_a, const unsigned char* mask_a,
                           const float* rows_b, const unsigned char* mask_b, int k, int W,
                           int slot, long long R, void* stream) {
  if (k < 1 || k > 2 || W < 1 || Q_cap < 2LL * W || Q_cap > Q)
    return (int)cudaErrorInvalidValue;
  Cand cand;
  cand.rows[0] = rows_a;
  cand.rows[1] = k == 2 ? rows_b : rows_a;
  cand.mask[0] = mask_a;
  cand.mask[1] = k == 2 ? mask_b : mask_a;
  cand.W = W;
  const int N = k * W;
  pool_put_kernel<<<(N + PUT_THREADS - 1) / PUT_THREADS, PUT_THREADS, 0,
                    (cudaStream_t)stream>>>(reinterpret_cast<float4*>(pool), Q, Q_cap, count,
                                            dropped, stage_pix, stage_contrib, take, pix,
                                            contrib, cand, k, slot, R);
  return (int)cudaGetLastError();
}
