// The pool iteration's take, for the PyTorch port (sm_90a).
//
// Replaces: no kernel of hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py.
//   The JAX package leaves this step of `_run_pool` to XLA, which fuses it;
//   the port ran it as ~12 PyTorch ops (ops/trace.py::_pool_window,
//   _unpack_entry, _park), each a node of the chunk's CUDA graph.
//
// What it computes, per lane l of the pool width W: the window of the LIFO
// top, start = max(count - W, 0), and row start + l of the packed pool
// [o3 | d3 | w3 | ior | budget | from_refl | pix | pad 3], unpacked into the
// node kernels' per-ray inputs: o and d parked (1e9 and +z) where the lane
// is past count, w, ior, budget (int32, truncated), from_refl (1.0 / 0.0),
// pix (int32 through int64, as the plain twin converts), and [start, count].
// A lane past count reads its row as the twin does (the rows below start +
// W are never the dump row) and parks it.
//
// What bounds it on this card: neither. W rows of 64 B in, ~100 B a lane
// out: ~0.4 MB at W = 3584, a fraction of a microsecond of the card's
// bandwidth; what it removes is the ~12 graph nodes of the plain ops, each
// ~1.5 us of launch latency inside the graph.
//
// Design: one thread per lane, the row in four 16-byte loads.
#include "rt_common.cuh"

namespace {

__global__ void pool_take_kernel(const float4* __restrict__ pool,
                                 const long long* __restrict__ count, int W,
                                 float* __restrict__ o, float* __restrict__ d,
                                 float* __restrict__ w, float* __restrict__ ior,
                                 int* __restrict__ budget, float* __restrict__ frefl,
                                 int* __restrict__ pix, long long* __restrict__ take) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= W) return;
  const long long n = *count;
  const long long start = n - W > 0 ? n - W : 0;
  const long long idx = start + l;
  const bool active = idx < n;
  if (l == 0) {
    take[0] = start;
    take[1] = n;
  }
  float r[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(pool + idx * 4 + i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[3 * l + c] = active ? r[c] : 1e9f;
    d[3 * l + c] = active ? r[3 + c] : (c == 2 ? 1.0f : 0.0f);
    w[3 * l + c] = r[6 + c];
  }
  ior[l] = r[9];
  budget[l] = (int)r[10];
  frefl[l] = r[11] != 0.0f ? 1.0f : 0.0f;
  pix[l] = (int)(long long)r[12];
}

}  // namespace

// pool (Q + 1, 16) with the dump row last; count: the pool's int64 count
extern "C" int rt_pool_take(const float* pool, const long long* count, int W, float* o,
                            float* d, float* w, float* ior, int* budget, float* frefl,
                            int* pix, long long* take, void* stream) {
  if (W > 0)
    pool_take_kernel<<<(W + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(pool), count, W, o, d, w, ior, budget, frefl, pix,
        take);
  return (int)cudaGetLastError();
}
