// The pool iteration's hit record, for the PyTorch port (sm_90a).
//
// Replaces: no kernel of hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py.
//   The JAX package leaves the spheres and the cast's epilogue to XLA
//   (intersect.py::cast_rays around `pallas_cast_triangles`); the port ran
//   them as ~60 PyTorch ops a pool iteration (ops/intersect.py::
//   _sphere_nearest, _hit_record; ops/trace.py::_active_hit, _hit_fields),
//   each a node of the chunk's CUDA graph.
//
// What it computes, per lane of the pool width W, after the triangle cast
// (#1, cast_triangles.cu) of the parked rays (o, d): the nearest sphere
// (the reference's root preference, back-face culling when asked, invalid
// slots out; the first sphere on equal t, sphere 0 when none is hit), the
// triangle hit folded in with a strict `<` at index S + tidx, validity
// (t finite), the hit point o + d * t (0 for a miss), the packed material
// row of the hit object, the normal (a sphere's normalized(point - center),
// a triangle's row normal), hval = valid and the lane below count, and the
// point parked at 1e9 where hval is false. Outputs are the node kernel's
// per-ray hit inputs, each contiguous in its dtype: point, normal, color
// (W, 3); shininess, valid (1.0 / 0.0), t, has_trans (1.0 / 0.0),
// metallic, ior, opacity, boost (W,).
//
// Every formula is the plain twin's, operation by operation and in its
// order (ops/intersect.py::_sphere_ts, _sphere_cos, _hit_record;
// ops/vecmath.py::normalized): the build uses --fmad=false and no fast
// math, so kernel and twin round alike.
//
// What bounds it on this card: neither. ~40 f32 operations a (lane, sphere
// slot) pair, 16 slots at semesterbild; ~100 B a lane in and out. What it
// removes is ~60 graph nodes of plain ops, each ~1.5 us of launch latency.
//
// Design: a warp per lane, 4 warps a thread block. The warp's lanes take
// the sphere slots of the sphere pack (sph_pack: center 0-2, r^2 3,
// transmissive 8, valid 12), one each (in rounds of 32 past 32 slots), so
// the slots' loads and square roots run side by side rather than as one
// thread's chain (a thread per lane and its 16 slots in order took 6.5 us a
// call at W = 2048 on an H100); the warp's minimum (t, slot) by shuffles,
// then lane 0 writes the record. Order of slots, the first on equal t: the
// one-thread scan's result.
#include "rt_common.cuh"

namespace {

struct HitOut {
  float *point, *normal, *color, *shin, *valid, *t, *httr, *met, *hior, *opac, *boost;
};

// normalized(v) as ops/vecmath.py: v * (1 / sqrt((vx*vx + vy*vy) + vz*vz))
__device__ __forceinline__ void unit(float* v) {
  const float r = 1.0f / sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
  v[0] = v[0] * r;
  v[1] = v[1] * r;
  v[2] = v[2] * r;
}

// Sphere slot s of the sphere pack for the ray (o, d): its t as
// ops/intersect.py::_sphere_ts, +inf where it is no valid hit or the
// back-face cull drops it (_sphere_nearest)
__device__ __forceinline__ float sphere_t(const float* __restrict__ c, float ox, float oy,
                                          float oz, float dx, float dy, float dz, int backface) {
  const float cx = c[0], cy = c[1], cz = c[2];
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = 2.0f * ((dx * ocx + dy * ocy) + dz * ocz);
  const float cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - c[3];
  const float disc = b * b - 4.0f * cc;
  const bool disc_pos = disc >= 0.0f;
  const float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
  const float t0 = (-b - sq) * 0.5f;
  const float t1 = (-b + sq) * 0.5f;
  const bool t0v = (t0 >= 0.0f) && disc_pos;
  const bool t1v = (t1 >= 0.0f) && disc_pos;
  const bool use0 = t0v && (!t1v || (t0 < t1));
  const bool use1 = t1v && !use0;
  const float t = use0 ? t0 : (use1 ? t1 : RT_INF);
  bool valid = (use0 || use1) && (c[12] != 0.0f);
  if (backface) {
    // _sphere_cos at t (0 where invalid): d . normalized(o + d * t - center)
    const float tv = valid ? t : 0.0f;
    float n[3] = {(ox + dx * tv) - cx, (oy + dy * tv) - cy, (oz + dz * tv) - cz};
    unit(n);
    const float cs = (dx * n[0] + dy * n[1]) + dz * n[2];
    valid = valid && ((cs < 0.75f) || (c[8] != 0.0f));
  }
  return valid ? t : RT_INF;
}

__global__ void pool_hit_kernel(const float* __restrict__ sph, int S,
                                const float* __restrict__ mat, const float* __restrict__ o,
                                const float* __restrict__ d, const float* __restrict__ tt,
                                const int* __restrict__ tidx,
                                const long long* __restrict__ take, int W, int backface,
                                HitOut out) {
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // a warp per lane
  const int lane = threadIdx.x & 31;
  if (l >= W) return;  // warp-uniform
  const bool active = l < take[1] - take[0];
  const float ox = o[3 * l], oy = o[3 * l + 1], oz = o[3 * l + 2];
  const float dx = d[3 * l], dy = d[3 * l + 1], dz = d[3 * l + 2];

  // the nearest sphere (ops/intersect.py::_sphere_nearest): lane j takes
  // slots j, j + 32, ... and keeps its first smallest t; then the warp's
  // smallest (t, slot), the first slot on equal t (torch.min / argmin), so
  // slot 0 where none is hit
  float best_t = RT_INF;
  int best = lane < S ? lane : 0x7fffffff;
  for (int s = lane; s < S; s += 32) {
    const float t = sphere_t(sph + 16 * s, ox, oy, oz, dx, dy, dz, backface);
    if (s == lane || t < best_t) {
      best_t = t;
      best = s;
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ot = __shfl_xor_sync(RT_WARP, best_t, m);
    const int os = __shfl_xor_sync(RT_WARP, best, m);
    if (ot < best_t || (ot == best_t && os < best)) {
      best_t = ot;
      best = os;
    }
  }
  if (lane != 0) return;

  // the triangle hit folded in, point, row and normal (_hit_record)
  long long idx = best;
  const float tri_t = tt[l];
  if (tri_t < best_t) {
    best_t = tri_t;
    idx = S + (long long)tidx[l];
  }
  const bool valid = isfinite(best_t);
  const float ts = valid ? best_t : 0.0f;
  const float p[3] = {ox + dx * ts, oy + dy * ts, oz + dz * ts};
  const float* row = mat + 16 * idx;
  float nrm[3] = {row[9], row[10], row[11]};
  if (idx < S) {
    nrm[0] = p[0] - nrm[0];
    nrm[1] = p[1] - nrm[1];
    nrm[2] = p[2] - nrm[2];
    unit(nrm);
  }
  const bool hval = valid && active;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.point[3 * l + c] = hval ? p[c] : 1e9f;
    out.normal[3 * l + c] = nrm[c];
    out.color[3 * l + c] = row[c];
  }
  out.met[l] = row[3];
  out.shin[l] = row[4];
  out.hior[l] = row[5];
  out.opac[l] = row[6];
  out.httr[l] = row[7] != 0.0f ? 1.0f : 0.0f;
  out.boost[l] = row[8];
  out.valid[l] = hval ? 1.0f : 0.0f;
  out.t[l] = best_t;
}

}  // namespace

// sph: the sphere pack (S, 16); mat: the material pack (N, 16); o, d: the
// parked rays (W, 3); tt, tidx: the triangle cast's nearest hit; take:
// [start, count] of pool_take
extern "C" int rt_pool_hit(const float* sph, int S, const float* mat, const float* o,
                           const float* d, const float* tt, const int* tidx,
                           const long long* take, int W, int backface, float* point,
                           float* normal, float* color, float* shin, float* valid, float* t,
                           float* httr, float* met, float* hior, float* opac, float* boost,
                           void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  const HitOut out = {point, normal, color, shin, valid, t, httr, met, hior, opac, boost};
  if (W > 0)
    pool_hit_kernel<<<(W + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
        sph, S, mat, o, d, tt, tidx, take, W, backface, out);
  return (int)cudaGetLastError();
}
