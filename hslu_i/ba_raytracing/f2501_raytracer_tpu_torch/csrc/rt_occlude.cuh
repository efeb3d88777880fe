// Shadow accumulators of one shadow ray over triangle rows, shared by the
// port's shading kernels (through rt_light.cuh) and its two occlusion
// kernels (occlude_triangles.cu, occlude_triangles_stream.cu).
//
// The sums are the plain path's (ops/intersect.py::_pack_occlusion; ref
// raytracer.rs:24-106): over the hits with t <= maxd,
//   dec = sum(1 - opacity * T_red)   (T_red: shadow Fresnel, red channel;
//                                     0 for an opaque occluder)
//   opq = any opaque hit
//   fr, fg, fb = sum(absorption)
// One thread owns a ray and scans in storage order, so a ray's f32 sums are
// the same bits on every run (no atomics, no cross-thread reduction).
#pragma once

#include "rt_common.cuh"

struct Occl {
  float dec, fr, fg, fb;
  bool opq;
};

// Shadow accumulators of one triangle row for the shadow ray (so, ld, maxd)
__device__ __forceinline__ void occl_tri(const float* __restrict__ w, float sox,
                                         float soy, float soz, float ldx, float ldy,
                                         float ldz, float maxd, bool backface,
                                         bool trans_section, Occl* acc) {
  float t;
  bool valid = rt_tri_test(w, sox, soy, soz, ldx, ldy, ldz, &t);
  const bool httr = w[14] != 0.0f;
  const float cos_nv = -rt_dot_normal(w, ldx, ldy, ldz);
  if (backface) valid = valid && ((-cos_nv < 0.75f) || httr);
  if (!(valid && t <= maxd)) return;
  float io = 0.0f;  // all-opaque rows: every hit decrements opacity fully
  if (trans_section && httr) io = w[19] * rt_shadow_tr_red(cos_nv, w[18], w[20], w[21], true);
  acc->dec += 1.0f - io;
  acc->opq = acc->opq || !httr;
  acc->fr += w[22];
  acc->fg += w[23];
  acc->fb += w[24];
}

__device__ __forceinline__ void add_part(Occl* tot, const Occl& part) {
  tot->dec += part.dec;
  tot->fr += part.fr;
  tot->fg += part.fg;
  tot->fb += part.fb;
  tot->opq = tot->opq || part.opq;
}

// Rows [0, n) of one pack (the big-primitive pack or one Morton block):
// the pack's partial sums are added to the total, as the plain path adds
// one `_pack_occlusion` result per pack. The scan of the pack stops at its
// first opaque hit. Returns tot->opq.
__device__ __forceinline__ bool occl_pack(const float* __restrict__ rows, int n, float sox,
                                          float soy, float soz, float ldx, float ldy,
                                          float ldz, float maxd, bool backface,
                                          bool trans_section, Occl* tot) {
  Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
  for (int c = 0; c < n && !part.opq; ++c)
    occl_tri(rows + c * 32, sox, soy, soz, ldx, ldy, ldz, maxd, backface, trans_section, &part);
  add_part(tot, part);
  return tot->opq;
}

// Morton blocks [b0, b1) of `pack` (nb, B, 32) in storage order, each
// behind the widened gate of its box in `aabb` (nb, 8) against the segment
// [0, maxd]; the shadow Fresnel runs only on blocks whose `block_httr`
// entry is non-zero (the per-block any-transmissive table). Stops at the
// first opaque hit and returns tot->opq: a ray that is occluded keeps
// whatever had been summed, which no caller reads.
__device__ __forceinline__ bool occl_blocks(const float* __restrict__ pack,
                                            const float* __restrict__ aabb,
                                            const float* __restrict__ block_httr, int b0,
                                            int b1, int B, float sox, float soy, float soz,
                                            float ldx, float ldy, float ldz, float ix,
                                            float iy, float iz, float maxd, bool backface,
                                            Occl* tot) {
  for (int b = b0; b < b1; ++b) {
    if (!rt_gate(aabb + b * 8, sox, soy, soz, ix, iy, iz, maxd)) continue;
    if (occl_pack(pack + (size_t)b * B * 32, B, sox, soy, soz, ldx, ldy, ldz, maxd, backface,
                  block_httr[b] != 0.0f, tot))
      return true;
  }
  return false;
}

__device__ __forceinline__ void occl_store(const Occl& tot, int r, float* __restrict__ dec,
                                           unsigned char* __restrict__ opq,
                                           float* __restrict__ fsub) {
  dec[r] = tot.dec;
  opq[r] = tot.opq ? 1 : 0;
  fsub[3 * r] = tot.fr;
  fsub[3 * r + 1] = tot.fg;
  fsub[3 * r + 2] = tot.fb;
}
