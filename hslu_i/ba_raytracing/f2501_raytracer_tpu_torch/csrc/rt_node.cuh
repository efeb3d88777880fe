// One shading-tree node per thread: lighting (rt_light.cuh), the distance
// attenuation, the transmissive combine rule, and the reflection /
// refraction children (Fresnel, TIR, adaptive depth budgets, weight
// cutoff). Shared by the two node kernels, which differ only in how they
// write the children: shade_eval_rows.cu as packed (R, 16) pool rows,
// shade_eval.cu as per-field arrays.
//
// Replaces the body of `_shade_eval_kernel` (hslu_i/ba_raytracing/
// f2501_raytracer_tpu/ops/pallas_kernels.py:1858) before its output
// stores. Follows the plain path (ops/shading.py::light_sums +
// ops/trace.py::_node_children) operation by operation.
#pragma once

#include "rt_light.cuh"

// Per-ray node state and hit fields, and the node's constants.
struct NodeParams {
  const float *point, *normal, *view, *color, *shin, *valid, *t, *w, *rior;
  const int* budget;
  const float *frefl, *httr, *met, *hior, *opac, *boost;
  int R;
  float eps, weight_cutoff, air;
  int reflections, refractions, refl_max, refr_max;
};

// One child entry. ior: the medium it travels in; budget: its depth budget.
struct Child {
  float o[3], d[3], w[3], ior;
  int budget;
  bool mask;
};

// compute_fresnel (ops/shading.py; ref material.rs:467-525), one channel set
__device__ __forceinline__ void fresnel3(float inx, float iny, float inz, float vx,
                                         float vy, float vz, float other, float hior,
                                         float met, bool httr, float mcr, float mcg,
                                         float mcb, float* F) {
  const float ndv = (inx * vx + iny * vy) + inz * vz;
  const float cs = fabsf(ndv);
  const bool is_in = ndv < 0.0f;
  const float eta_t = is_in ? hior / other : other / hior;
  const float sin2 = eta_t * eta_t * (1.0f - cs * cs);
  const bool refl = met > 0.0f;
  const bool tir = (httr && is_in && (sin2 > 1.0f)) || refl;
  const float q = (other - hior) / (other + hior);
  const float f0 = q * q;
  const float omc5 = rt_pow5(1.0f - cs);
  const float mc[3] = {mcr, mcg, mcb};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f0c = f0 + (mc[k] - f0) * met;
    const float fres = f0c + (1.0f - f0c) * omc5;
    const float f = tir ? (refl ? met : 1.0f) : fres;
    F[k] = httr ? f : met;
  }
}

// max(w) > cutoff with NaN propagation (jnp.max / torch.amax)
__device__ __forceinline__ bool above_cutoff(const float* w, float cutoff) {
  if (!(cutoff > 0.0f)) return true;
  if (isnan(w[0]) || isnan(w[1]) || isnan(w[2])) return false;
  return fmaxf(w[0], fmaxf(w[1], w[2])) > cutoff;
}

// Evaluate ray r's node: contrib (3,) and both children. A disabled child
// type is left untouched (the caller writes its zeros).
__device__ void rt_eval_node(const ShadeScene& sc, const Tables& tb, const NodeParams& p,
                             int r, float* contrib, Child* rfl, Child* rfr) {
  const bool hval = p.valid[r] != 0.0f;
  const float px = p.point[3 * r], py = p.point[3 * r + 1], pz = p.point[3 * r + 2];
  const float nx = p.normal[3 * r], ny = p.normal[3 * r + 1], nz = p.normal[3 * r + 2];
  const float dx = p.view[3 * r], dy = p.view[3 * r + 1], dz = p.view[3 * r + 2];
  const float mcr = p.color[3 * r], mcg = p.color[3 * r + 1], mcb = p.color[3 * r + 2];

  float lit[3], spc[3];
  rt_light_sums(sc, tb, p.eps, hval, px, py, pz, nx, ny, nz, dx, dy, dz, mcr, mcg, mcb,
                p.shin[r], lit, spc);
  // ambient = material colour * 0.08 on valid rays (ops/shading.py)
  const float amb = hval ? 0.08f : 0.0f;
  const float dir[3] = {mcr * amb + lit[0], mcg * amb + lit[1], mcb * amb + lit[2]};

  // ---- node contribution (ops/trace.py::_node_children) ----
  const float ta = fabsf(p.t[r]);
  float dist_f = fminf(fmaxf(1.0f / ((1.0f + ta) + 0.1f * ta * ta), 0.0f), 1.0f);
  dist_f = hval ? dist_f : 0.0f;
  const bool httr = p.httr[r] != 0.0f;
  const bool from_refl = p.frefl[r] != 0.0f;
  const float wf = from_refl ? dist_f : 1.0f;
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = p.w[3 * r + k] * wf;
    const float node = (httr ? 0.0f : dir[k] * dist_f) + spc[k] * dist_f;
    contrib[k] = hval ? w[k] * node : 0.0f;
  }

  const float met = p.met[r], hior = p.hior[r], rior = p.rior[r];
  const int budget = p.budget[r];
  const float cos_theta = (dx * nx + dy * ny) + dz * nz;

  // ---- reflection child (raytracer_renderer.rs:526-729) ----
  if (p.reflections) {
    const bool inside = cos_theta < 0.0f;
    const float inx = inside ? -nx : nx, iny = inside ? -ny : ny, inz = inside ? -nz : nz;
    const float new_ior = inside ? hior : p.air;
    const float eta = inside ? new_ior / rior : rior / new_ior;
    const float cos_i = fabsf(cos_theta);
    const bool tir = eta * eta * (1.0f - cos_i * cos_i) >= 1.0f;
    const bool reflective = (met > 0.0f) || (httr && tir);
    const float c2 = 2.0f * cos_theta;
    const float rx = dx - c2 * nx, ry = dy - c2 * ny, rz = dz - c2 * nz;
    const float inv = 1.0f / sqrtf((rx * rx + ry * ry) + rz * rz);
    const float rd[3] = {rx * inv, ry * inv, rz * inv};
    float F[3];
    fresnel3(inx, iny, inz, -dx, -dy, -dz, rior, hior, met, httr, mcr, mcg, mcb, F);
    const int cb = budget < 0 ? p.refl_max : max(budget - 1, 0);
    const float pt[3] = {px, py, pz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rfl->o[k] = pt[k] + rd[k] * p.eps;
      rfl->d[k] = rd[k];
      rfl->w[k] = w[k] * F[k];
    }
    rfl->ior = rior;  // reflection keeps the current medium (rs:703)
    rfl->budget = cb;
    rfl->mask = hval && reflective && (cb > 0) && above_cutoff(rfl->w, p.weight_cutoff);
  }

  // ---- refraction child (raytracer_renderer.rs:279-524) ----
  if (p.refractions) {
    const bool inside = cos_theta <= 0.0f;
    const float inx = inside ? -nx : nx, iny = inside ? -ny : ny, inz = inside ? -nz : nz;
    const float new_ior = inside ? hior : p.air;
    const float eta = inside ? new_ior / rior : rior / new_ior;
    const float inv_eta = 1.0f / eta;
    float F[3];
    fresnel3(inx, iny, inz, dx, dy, dz, inv_eta, hior, met, httr, mcr, mcg, mcb, F);
    // refracted(d, -inormal, inv_eta) (ops/vecmath.py)
    const float mx = -inx, my = -iny, mz = -inz;
    const float ndi = (mx * dx + my * dy) + mz * dz;
    const float k = 1.0f - inv_eta * inv_eta * (1.0f - ndi * ndi);
    const bool k_pos = k >= 0.0f;
    const float coef = inv_eta * ndi + sqrtf(fmaxf(k, 0.0f));
    const float qx = k_pos ? dx * inv_eta - coef * mx : 0.0f;
    const float qy = k_pos ? dy * inv_eta - coef * my : 0.0f;
    const float qz = k_pos ? dz * inv_eta - coef * mz : 0.0f;
    const float inv = 1.0f / sqrtf((qx * qx + qy * qy) + qz * qz);
    const float td[3] = {k_pos ? qx * inv : 0.0f, k_pos ? qy * inv : 0.0f,
                         k_pos ? qz * inv : 0.0f};
    const float op = httr ? p.opac[r] : 0.0f;
    const int step = op < 0.5f ? 2 : 1;
    const int divisor = op <= 0.3f ? 3 : (op < 0.5f ? 2 : 1);
    const int cb = budget < 0 ? p.refr_max / divisor : max(budget - step, 0);
    const float boost_f = (httr ? p.boost[r] : 0.0f) + 1.0f;
    const float pt[3] = {px, py, pz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rfr->o[c] = pt[c] + td[c] * p.eps;
      rfr->d[c] = td[c];
      rfr->w[c] = w[c] * (1.0f - F[c]) * boost_f;
    }
    rfr->ior = new_ior;  // entering the new medium (rs:497)
    rfr->budget = cb;
    rfr->mask = hval && httr && (cb > 0) && k_pos && above_cutoff(rfr->w, p.weight_cutoff);
  }
}

// Fill NodeParams and ShadeScene from the C entry points' shared arguments.
static inline void rt_fill_node(ShadeScene* sc, NodeParams* p, const float* lights,
                                int n_lights, const float* sph, int S, const float* trb,
                                int P, int trans_rows, const float* blk,
                                const float* blk_aabb, int nb, int B, int n_trans_blocks,
                                const float* point, const float* normal, const float* view,
                                const float* color, const float* shin, const float* valid,
                                const float* t, const float* w, const float* rior,
                                const int* budget, const float* frefl, const float* httr,
                                const float* met, const float* hior, const float* opac,
                                const float* boost, int R, float eps, int backface,
                                int reflections, int refractions, int refl_max,
                                int refr_max, float weight_cutoff, float air) {
  *sc = ShadeScene{lights, sph, trb, blk, blk_aabb, n_lights, S, P, trans_rows,
                   nb, B, n_trans_blocks, backface};
  p->point = point; p->normal = normal; p->view = view; p->color = color; p->shin = shin;
  p->valid = valid; p->t = t; p->w = w; p->rior = rior; p->budget = budget;
  p->frefl = frefl; p->httr = httr; p->met = met; p->hior = hior; p->opac = opac;
  p->boost = boost; p->R = R; p->eps = eps; p->weight_cutoff = weight_cutoff;
  p->air = air; p->reflections = reflections; p->refractions = refractions;
  p->refl_max = refl_max; p->refr_max = refr_max;
}
