// Device helpers shared by all of the port's CUDA kernels. Every formula
// follows the plain PyTorch twin in ops/intersect.py / ops/shading.py /
// ops/trace.py operation by operation,
// in the same order: the build uses --fmad=false and no fast math, so a
// kernel and its twin round alike.
//
// Triangle row layout (scene/device.py, 32 floats per triangle, the JAX
// package's trb_pack lane map): 0-11 Woop coefficients (3k+c: input
// component k, output coordinate c; 9-11 translation), 12 |n|^2, 13 valid,
// 14 transmissive, 15-17 shading normal, 18 ior, 19 opacity, 20 metallic,
// 21 color.r, 22-24 absorption.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_EPS 1.1920928955078125e-07f  // f32::EPSILON = 2^-23
#define RT_INF __int_as_float(0x7f800000)

// Woop ray/triangle test (JAX intersect.py::_tri_block_ts): returns validity
// (no backface term) and t.
__device__ __forceinline__ bool rt_tri_test(const float* __restrict__ w, float ox,
                                            float oy, float oz, float dx, float dy,
                                            float dz, float* t_out) {
  const float uo = ((ox * w[0] + oy * w[3]) + oz * w[6]) + w[9];
  const float vo = ((ox * w[1] + oy * w[4]) + oz * w[7]) + w[10];
  const float wo = ((ox * w[2] + oy * w[5]) + oz * w[8]) + w[11];
  const float ud = (dx * w[0] + dy * w[3]) + dz * w[6];
  const float vd = (dx * w[1] + dy * w[4]) + dz * w[7];
  const float wd = (dx * w[2] + dy * w[5]) + dz * w[8];
  const float t = -wo / wd;
  const float u = uo + t * ud;
  const float v = vo + t * vd;
  const float det = wd * w[12];  // = d . n = det([d, -e1, -e2])
  *t_out = t;
  return (t > RT_EPS) && (u >= 0.0f) && (v >= 0.0f) && (u + v < 1.0f) &&
         (fabsf(det) > RT_EPS) && (w[13] != 0.0f);
}

// d . shading normal of a triangle row, left to right
__device__ __forceinline__ float rt_dot_normal(const float* __restrict__ w, float dx,
                                               float dy, float dz) {
  return (dx * w[15] + dy * w[16]) + dz * w[17];
}

// One slab of the AABB gate. The TPU kernel (pallas_kernels.py::_gate_flat)
// relies on jnp.minimum/maximum PROPAGATING NaN (0 * inf when a direction
// component is 0 and the origin lies on the slab plane) and then maps a NaN
// lo to -inf and a NaN hi to +inf. fminf/fmaxf DROP NaN instead, which would
// cull a block that must be tested, so the NaN case is spelled out here.
__device__ __forceinline__ void rt_slab(float lo, float hi, float o, float inv,
                                        float* tn, float* tf) {
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  const bool nan = isnan(t1) || isnan(t2);
  const float a = nan ? -RT_INF : fminf(t1, t2);
  const float b = nan ? RT_INF : fmaxf(t1, t2);
  *tn = fmaxf(*tn, a);
  *tf = fminf(*tf, b);
}

// Relative widening of every gate box face. f32 rounding in the slab test
// and in the Woop hit can disagree by a few ulp, so an exact box could cull
// a block whose hit lies on its face (the procedural text mesh is made of
// axis-aligned boxes). A margin of 1e-5 * (1 + |coordinate|) is far above
// that rounding (~1e-7 relative) and keeps the gate conservative: a block
// holding a hit nearer than t_limit is never culled, so the gated kernels
// return exactly what their ungated twins return.
#define RT_GATE_REL 1e-5f

// Does the segment [0, t_limit] of the ray cross the (widened) box?
// box: [min xyz | max xyz | pad 2].
__device__ __forceinline__ bool rt_gate(const float* __restrict__ box, float ox,
                                        float oy, float oz, float ix, float iy,
                                        float iz, float t_limit) {
  float tn = -RT_INF, tf = RT_INF;
  const float o3[3] = {ox, oy, oz};
  const float i3[3] = {ix, iy, iz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = box[c], hi = box[c + 3];
    const float m = RT_GATE_REL * (1.0f + fmaxf(fabsf(lo), fabsf(hi)));
    rt_slab(lo - m, hi + m, o3[c], i3[c], &tn, &tf);
  }
  return (tf >= fmaxf(tn, 0.0f)) && (tn <= t_limit);
}

// Nearest hit over the Morton blocks [b0, b1) of `pack` (nb, B, 32) in
// storage order, each behind the gate of its box in `aabb` against the
// ray's own best t so far. Strict `<`: on equal t the earlier block and the
// lower slot win. Slot (b, c) gets the index base + b*B + c.
__device__ __forceinline__ void rt_cast_blocks(const float* __restrict__ pack,
                                               const float* __restrict__ aabb, int b0, int b1,
                                               int B, int base, float ox, float oy, float oz,
                                               float dx, float dy, float dz, float ix,
                                               float iy, float iz, bool backface,
                                               float* best_t, int* best_idx) {
  for (int b = b0; b < b1; ++b) {
    if (!rt_gate(aabb + b * 8, ox, oy, oz, ix, iy, iz, *best_t)) continue;
    const float* blk = pack + (size_t)b * B * 32;
    for (int c = 0; c < B; ++c) {
      const float* w = blk + c * 32;
      float t;
      bool valid = rt_tri_test(w, ox, oy, oz, dx, dy, dz, &t);
      if (backface)
        valid = valid && ((rt_dot_normal(w, dx, dy, dz) < 0.75f) || (w[14] != 0.0f));
      if (valid && t < *best_t) {
        *best_t = t;
        *best_idx = base + b * B + c;
      }
    }
  }
}

// x**5 in XLA's binary-exponentiation order, as ops/intersect.py::pow5
__device__ __forceinline__ float rt_pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// Red channel of the shadow Fresnel transmittance 1 - F through a
// transmissive occluder (JAX intersect.py::_shadow_transmittance_red;
// ref material.rs:467-525 with other_ior = 1, raytracer.rs:57-74).
__device__ __forceinline__ float rt_shadow_tr_red(float cos_nv, float ior, float met,
                                                  float col_r, bool httr) {
  const float cos_theta = fabsf(cos_nv);
  const bool inside = cos_nv < 0.0f;
  const float eta_t = inside ? ior : 1.0f / ior;
  const float sin2_t = eta_t * eta_t * (1.0f - cos_theta * cos_theta);
  const bool refl = met > 0.0f;
  const bool tir = (httr && inside && (sin2_t > 1.0f)) || refl;
  const float q = (1.0f - ior) / (1.0f + ior);
  const float f0 = q * q;
  const float f0r = f0 + (col_r - f0) * met;
  const float fres = f0r + (1.0f - f0r) * rt_pow5(1.0f - cos_theta);
  float f = tir ? (refl ? met : 1.0f) : fres;
  f = httr ? f : met;
  return 1.0f - f;
}
