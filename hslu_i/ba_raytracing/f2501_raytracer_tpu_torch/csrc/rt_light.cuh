// Direct + specular lighting with the hard-shadow scan, shared by the
// port's three shading kernels (light_shade.cu, shade_eval.cu,
// shade_eval_rows.cu).
//
// Replaces the shading core of the TPU kernels in
// hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py:
// `_light_sums` (line 1662) with its shadow scan (`_sphere_occl_comp` 803,
// `_bigtri_occl_split` 1188, `_tri_occl_lights_lanegate` /
// `_tri_occl_lights` 1370 / 1519). It follows the plain path
// (ops/shading.py::light_sums) operation by operation, one ray per thread
// and one light at a time; it does not copy the TPU kernel's rescaled
// pair math or its 8-light chunks, so only the f32 sum order over lights
// differs from the TPU (it matches the plain twin's order).
//
// Early exits, all exact: a light behind the surface (cos_in <= 0) has
// intensity and colour exactly 0 and skips its scan; a light's scan stops
// at the first opaque occluder, because an occluded light contributes
// nothing (can_reach is false and every term that reads the shadow sums is
// discarded). Only the first n_lights rows of the light pack are read: the
// pack is padded to a multiple of 8 rows, and the padding is never a light.
#pragma once

#include "rt_common.cuh"

// The scene tables a shading kernel reads. Light rows: [pos3 | color3 |
// intensity | pad]; sphere rows (16 floats): [c3 | r^2 | ior | opacity |
// metallic | color.r | transmissive | absorption3 | valid | pad3];
// triangle rows (32 floats): rt_common.cuh.
struct ShadeScene {
  const float *lights, *sph, *trb, *blk, *blk_aabb;
  int n_lights, S, P, trans_rows, nb, B, n_trans_blocks, backface;
};

// Bytes of the small tables (the lights in use, spheres, big primitives)
// and whether they are staged in shared memory (the default 48 KB).
static inline size_t rt_table_bytes(const ShadeScene& sc) {
  return sizeof(float) * ((size_t)sc.n_lights * 8 + (size_t)sc.S * 16 + (size_t)sc.P * 32);
}
static inline bool rt_tables_fit(const ShadeScene& sc) { return rt_table_bytes(sc) <= 48 * 1024; }

// Table pointers as a thread sees them: shared memory when staged.
struct Tables {
  const float *lights, *sph, *trb;
};

// Every thread of the block calls this (it synchronises) before any thread
// returns.
__device__ __forceinline__ Tables rt_stage_tables(const ShadeScene& sc, bool staged,
                                                  float* smem) {
  if (!staged) return Tables{sc.lights, sc.sph, sc.trb};
  const int nl = sc.n_lights * 8, ns = sc.S * 16, nt = sc.P * 32;
  for (int i = threadIdx.x; i < nl + ns + nt; i += blockDim.x)
    smem[i] = i < nl ? sc.lights[i] : (i < nl + ns ? sc.sph[i - nl] : sc.trb[i - nl - ns]);
  __syncthreads();
  return Tables{smem, smem + nl, smem + nl + ns};
}

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

// Full shadow scan for one light; returns the totals (opq set => the rest
// was skipped and the sums are not used). Per-pack partial sums are added
// to the total in the plain path's order: spheres, big primitives, then
// each Morton block.
__device__ Occl rt_shadow_scan(const ShadeScene& sc, const Tables& tb, float sox,
                               float soy, float soz, float ldx, float ldy, float ldz,
                               float maxd) {
  const bool bf = sc.backface != 0;
  Occl tot = {0.0f, 0.0f, 0.0f, 0.0f, false};
  // spheres (JAX intersect.py::_sphere_occlusion)
  for (int s = 0; s < sc.S; ++s) {
    const float* q = tb.sph + s * 16;
    const float ocx = sox - q[0], ocy = soy - q[1], ocz = soz - q[2];
    const float b = 2.0f * ((ldx * ocx + ldy * ocy) + ldz * ocz);
    const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - q[3];
    const float disc = b * b - 4.0f * c;
    const bool disc_pos = disc >= 0.0f;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = (-b - sq) * 0.5f;
    const float t1 = (-b + sq) * 0.5f;
    const bool t0v = (t0 >= 0.0f) && disc_pos;
    const bool t1v = (t1 >= 0.0f) && disc_pos;
    const bool use0 = t0v && (!t1v || (t0 < t1));
    const bool use1 = t1v && !use0;
    const float t = use0 ? t0 : (use1 ? t1 : RT_INF);
    bool sval = (use0 || use1) && (q[12] != 0.0f);
    const float ts = sval ? t : 0.0f;
    const float nvx = (sox + ldx * ts) - q[0];
    const float nvy = (soy + ldy * ts) - q[1];
    const float nvz = (soz + ldz * ts) - q[2];
    const float inv_n = 1.0f / sqrtf((nvx * nvx + nvy * nvy) + nvz * nvz);
    const float cs = (ldx * (nvx * inv_n) + ldy * (nvy * inv_n)) + ldz * (nvz * inv_n);
    const bool httr = q[8] != 0.0f;
    if (bf) sval = sval && ((cs < 0.75f) || httr);
    if (!(sval && t <= maxd)) continue;
    const float io = httr ? q[5] * rt_shadow_tr_red(-cs, q[4], q[6], q[7], true) : 0.0f;
    tot.dec += 1.0f - io;
    tot.opq = tot.opq || !httr;
    tot.fr += q[9];
    tot.fg += q[10];
    tot.fb += q[11];
  }
  if (tot.opq) return tot;
  // big primitives: transmissive rows lead the pack
  {
    Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
    for (int r = 0; r < sc.P && !part.opq; ++r)
      occl_tri(tb.trb + r * 32, sox, soy, soz, ldx, ldy, ldz, maxd, bf, r < sc.trans_rows, &part);
    add_part(&tot, part);
  }
  if (tot.opq) return tot;
  // Morton blocks (transmissive blocks first), behind the block gate
  const float ix = 1.0f / ldx, iy = 1.0f / ldy, iz = 1.0f / ldz;
  for (int b = 0; b < sc.nb; ++b) {
    if (!rt_gate(sc.blk_aabb + b * 8, sox, soy, soz, ix, iy, iz, maxd)) continue;
    const float* blk = sc.blk + (size_t)b * sc.B * 32;
    const bool trans = b < sc.n_trans_blocks;
    Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
    for (int c = 0; c < sc.B && !part.opq; ++c)
      occl_tri(blk + c * 32, sox, soy, soz, ldx, ldy, ldz, maxd, bf, trans, &part);
    add_part(&tot, part);
    if (tot.opq) return tot;
  }
  return tot;
}

// Direct and specular light of one ray over the first n_lights lights,
// WITHOUT ambient (ops/shading.py::light_sums; ref raytracer_renderer.rs:
// 731-874). view = the ray direction (the reference's specular "view"
// points at the surface). dir / spc: (3,) outputs, 0 for an invalid ray.
__device__ void rt_light_sums(const ShadeScene& sc, const Tables& tb, float eps, bool hval,
                              float px, float py, float pz, float nx, float ny, float nz,
                              float dx, float dy, float dz, float mcr, float mcg, float mcb,
                              float shin, float* dir, float* spc) {
  float lr = 0.0f, lg = 0.0f, lb = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
  if (hval) {
    const bool has_spec = shin > 0.0f;
    const float spec_exp = fmaxf(shin * 512.0f, 1.0f);
    for (int l = 0; l < sc.n_lights; ++l) {
      const float* L = tb.lights + l * 8;
      const float ltx = L[0] - px, lty = L[1] - py, ltz = L[2] - pz;
      const float lt2 = (ltx * ltx + lty * lty) + ltz * ltz;
      const float inv_lt = 1.0f / sqrtf(lt2);
      const float ldx = ltx * inv_lt, ldy = lty * inv_lt, ldz = ltz * inv_lt;
      const float sox = px + ldx * eps, soy = py + ldy * eps, soz = pz + ldz * eps;
      const float dex = L[0] - sox, dey = L[1] - soy, dez = L[2] - soz;
      const float maxd = sqrtf((dex * dex + dey * dey) + dez * dez);
      // PointLight::calculate_contribution_at (light.rs:261-300)
      const float ldist = sqrtf(lt2) + RT_EPS;
      const float cos_in = ((ltx * nx + lty * ny) + ltz * nz) / ldist;
      if (!(cos_in > 0.0f)) continue;  // intensity and color are exactly 0
      const Occl occ = rt_shadow_scan(sc, tb, sox, soy, soz, ldx, ldy, ldz, maxd);
      if (occ.opq) continue;  // can_reach is false: the light adds nothing
      const float combined = fminf(fmaxf(1.0f - occ.dec, 0.0f), 1.0f);
      const float att = 0.95f * ((RT_EPS + ldist) + ldist * ldist);
      const float att_sig = (tanhf(att) + 1.0f) / 2.0f;
      const float ci = cos_in * L[6] * fminf(fmaxf(att_sig, 0.0f), 1.0f);
      // shadow filter division quirk (raytracer_renderer.rs:807-811)
      const float lcsr = (mcr * L[3]) / (1.0f - occ.fr);
      const float lcsg = (mcg * L[4]) / (1.0f - occ.fg);
      const float lcsb = (mcb * L[5]) / (1.0f - occ.fb);
      const float dln = (nx * ldx + ny * ldy) + nz * ldz;
      const float diffuse = fmaxf(dln, 0.0f);
      const float c2 = 2.0f * dln;
      const float srx = ldx - c2 * nx, sry = ldy - c2 * ny, srz = ldz - c2 * nz;
      const float inv_sr = 1.0f / sqrtf((srx * srx + sry * sry) + srz * srz);
      const float sdot = fmaxf(((srx * inv_sr) * dx + (sry * inv_sr) * dy) + (srz * inv_sr) * dz, 0.0f);
      const float spec_f = has_spec ? powf(sdot, spec_exp) : 0.0f;
      const float lf = diffuse * ci * combined;
      const float sf = ci * combined * spec_f;
      if (diffuse > 0.0f) {
        lr += mcr * lcsr * lf;
        lg += mcg * lcsg * lf;
        lb += mcb * lcsb * lf;
        if (has_spec) {
          sr += L[3] * sf;
          sg += L[4] * sf;
          sb += L[5] * sf;
        }
      }
    }
  }
  dir[0] = lr;
  dir[1] = lg;
  dir[2] = lb;
  spc[0] = sr;
  spc[1] = sg;
  spc[2] = sb;
}
