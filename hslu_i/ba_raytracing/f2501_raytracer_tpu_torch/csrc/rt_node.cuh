// One shading-tree node: lighting (rt_light.cuh), the distance
// attenuation, the transmissive combine rule, and the reflection /
// refraction children (Fresnel, TIR, adaptive depth budgets, weight
// cutoff). Shared by the two node kernels, shade_eval_rows.cu (packed (R,
// 16) pool rows) and shade_eval.cu (per-field arrays, over the rays that
// hit): both run rt_node_rays below, so they give the same bits.
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

// A ray's surface: the node's hit point, normal, view (= the ray
// direction) and material colour, and whether it hit anything.
struct Surf {
  bool hval;
  float px, py, pz, nx, ny, nz, dx, dy, dz, mcr, mcg, mcb;
};

__device__ __forceinline__ Surf rt_surf(const NodeParams& p, int r) {
  Surf s;
  s.hval = p.valid[r] != 0.0f;
  s.px = p.point[3 * r], s.py = p.point[3 * r + 1], s.pz = p.point[3 * r + 2];
  s.nx = p.normal[3 * r], s.ny = p.normal[3 * r + 1], s.nz = p.normal[3 * r + 2];
  s.dx = p.view[3 * r], s.dy = p.view[3 * r + 1], s.dz = p.view[3 * r + 2];
  s.mcr = p.color[3 * r], s.mcg = p.color[3 * r + 1], s.mcb = p.color[3 * r + 2];
  return s;
}

// Ray r's node from its lighting (lit: direct, spc: specular, without
// ambient): contrib (3,) and both children. A disabled child type is left
// untouched (the caller writes its zeros).
__device__ void rt_node_epilogue(const NodeParams& p, int r, const Surf& s, const float* lit,
                                 const float* spc, float* contrib, Child* rfl, Child* rfr) {
  const bool hval = s.hval;
  const float px = s.px, py = s.py, pz = s.pz, nx = s.nx, ny = s.ny, nz = s.nz;
  const float dx = s.dx, dy = s.dy, dz = s.dz, mcr = s.mcr, mcg = s.mcg, mcb = s.mcb;
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

// ---- the node kernels' body: one template for shade_eval_rows.cu and
// shade_eval.cu, which differ only in which rays a warp takes and how a
// node's outputs are stored --------------------------------------------------
//
// K = 1: a warp per ray; lane 0 holds the ray, and for each light in order a
// lit ray (cos_in > 0) writes its shadow ray and the lanes share its scan
// (rt_light.cuh::rt_warp_shadow_scan; the big rows staged once per thread
// block in the 80-byte layout). K = 32: a ray per lane, each lane scanning
// its ray's shadows alone (rt_light.cuh::rt_shadow_scan over the one-thread
// tables). In both, the lighting of a light (rt_light_ray, rt_light_add) and
// the node epilogue run on the lane that holds the ray, in the order of the
// plain path, so every form gives the same bits. K = RT_LIGHT_LANES
// (shade_eval_rows.cu only): a warp per ray whose lanes take its lights
// (rt_node_light_lanes below).
#define RT_LIGHT_LANES 0
// Lights whose terms a warp of the light-lanes form holds at a time
#define RT_LL_CHUNK 64

// A warp's shared memory in the form with a warp per ray: its rays' shadow
// records (rt_common.cuh's RT_RAY layout), their sums, and the stage of the
// Morton rows (the form with a ray per lane uses none of it).
template <int K>
struct NodeWarpShared {
  float rays[K == 32 ? 1 : K * RT_RAY];
  float sums[K == 32 ? 1 : K * OCCL_SUMS];
  float4 stage[K == 32 ? 1 : RT_STAGE_ROWS * RT_ROW4];
};

// ... and in the light-lanes form: the terms of a chunk of lights, six per
// light (channel c of light j at c * RT_LL_CHUNK + j), then whether each
// light adds them.
template <>
struct NodeWarpShared<RT_LIGHT_LANES> {
  float terms[7 * RT_LL_CHUNK];
};

// Bytes of the dynamic shared memory a node kernel's thread block stages:
// the one-thread tables (a ray per lane and the light-lanes form, where
// they fit), or the big rows in the 80-byte layout (a warp per ray).
__host__ inline size_t rt_node_dyn_bytes(const ShadeScene& sc, int K) {
  if (K != 1) return rt_tables_fit(sc) ? rt_table_bytes(sc) : 0;
  return sizeof(float4) * RT_ROW4 * sc.P;
}

// What a node kernel's thread block stages into `dyn` before its warps
// start; every thread calls this (it synchronises) before any returns.
template <int K>
__device__ __forceinline__ Tables rt_node_stage(const ShadeScene& sc, float4* dyn) {
  if constexpr (K != 1) {
    return rt_stage_tables(sc, rt_tables_fit(sc), reinterpret_cast<float*>(dyn));
  } else {
    rt_stage_block_rows(dyn, sc.trb, sc.P);
    return Tables{sc.lights, sc.sph, sc.trb};
  }
}

// The node of the ray r that this lane holds (r < 0: none) for the warp's
// lanes together: lighting over all lights, then rt_node_epilogue, whose
// results go to store(r, contrib, rfl, rfr) on the lane that holds r. K = 1:
// only lane 0 may hold a ray. All 32 lanes; RAGGED: sc.B is no multiple of
// 32.
template <int K, bool RAGGED, class Store>
__device__ __forceinline__ void rt_node_rays(const ShadeScene& sc, const Tables& tb,
                                             const WarpGate& g, const float4* big,
                                             const NodeParams& p, int lane, int r,
                                             NodeWarpShared<K>& sh, Store store) {
  Surf s;
  s.hval = false;
  float shin = 0.0f;
  if (r >= 0) {
    s = rt_surf(p, r);
    shin = p.shin[r];
  }
  const bool has_spec = shin > 0.0f;
  const float spec_exp = fmaxf(shin * 512.0f, 1.0f);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // direct, specular
  for (int l = 0; l < sc.n_lights; ++l) {
    const float* L = tb.lights + l * 8;
    LightRay q;
    bool lit = false;
    if (s.hval) {
      q = rt_light_ray(L, p.eps, s.px, s.py, s.pz, s.nx, s.ny, s.nz);
      lit = q.cos_in > 0.0f;  // else intensity and color are exactly 0
    }
    Occl occ = {0.0f, 0.0f, 0.0f, 0.0f, true};  // can_reach is false: the light adds nothing
    if constexpr (K == 32) {
      if (lit) occ = rt_shadow_scan(sc, tb, q.sox, q.soy, q.soz, q.ldx, q.ldy, q.ldz, q.maxd);
    } else {
      if (lit) {
        float* rec = sh.rays + lane * RT_RAY;
        rec[0] = q.sox, rec[1] = q.soy, rec[2] = q.soz;
        rec[3] = q.ldx, rec[4] = q.ldy, rec[5] = q.ldz;
        rec[6] = 1.0f / q.ldx, rec[7] = 1.0f / q.ldy, rec[8] = 1.0f / q.ldz;
        rec[9] = q.maxd;
      }
      const unsigned need = __ballot_sync(RT_WARP, lit);  // bit k: ray k
      if (!need) continue;
      __syncwarp();  // the records are written
      const unsigned opq = rt_warp_shadow_scan<K, RAGGED>(sc, g, big, lane, sh.rays, sh.sums,
                                                          need, sh.stage);
      if (lit) {
        const float* tot = sh.sums + lane * OCCL_SUMS;
        occ = Occl{tot[0], tot[1], tot[2], tot[3], (opq >> lane & 1u) != 0};
      }
      __syncwarp();  // the sums are read before the next light's scan writes them
    }
    if (!occ.opq)
      rt_light_add(L, q, occ.dec, occ.fr, occ.fg, occ.fb, s.nx, s.ny, s.nz, s.dx, s.dy, s.dz,
                   s.mcr, s.mcg, s.mcb, has_spec, spec_exp, acc);
  }
  if (r >= 0) {
    float contrib[3];
    Child rfl, rfr;
    rt_node_epilogue(p, r, s, acc, acc + 3, contrib, &rfl, &rfr);
    store(r, contrib, rfl, rfr);
  }
}

// The light-lanes form: the node of ray r, which the whole warp holds. Its
// lights go to the lanes in ceil(n_lights / 32) rounds of an even share
// (`width` lanes, so that a round takes neighbouring lights): light
// l0 + j0 + lane of each round, two rounds to a chunk, whose terms the warp
// holds. A lane traces its light's shadow ray (rt_light_ray) and scans it
// alone (rt_shadow_scan over the one-thread tables), then computes the
// light's six terms (rt_light_terms). The terms go to sh.terms, with a flag
// for each light that the one-thread loop skips (behind the surface,
// occluded, or diffuse <= 0); lane c < 6 then adds the terms of channel c in
// light order, skipping exactly the flagged lights, as rt_light_add adds
// them on one lane, so the sums have its bits (the port builds with
// --fmad=false). A ray without a hit scans nothing: its lighting is exactly
// 0. Lane 0 runs the epilogue and store(r, ...). All 32 lanes.
template <class Store>
__device__ __forceinline__ void rt_node_light_lanes(const ShadeScene& sc, const Tables& tb,
                                                    const NodeParams& p, int lane, int r,
                                                    NodeWarpShared<RT_LIGHT_LANES>& sh,
                                                    Store store) {
  const Surf s = rt_surf(p, r);
  const float shin = p.shin[r];
  const bool has_spec = shin > 0.0f;
  const float spec_exp = fmaxf(shin * 512.0f, 1.0f);
  float acc = 0.0f;  // lane c < 6: channel c of (direct, specular)
  const bool adder = lane < 3 || (lane < 6 && has_spec);
  float* flags = sh.terms + 6 * RT_LL_CHUNK;
  const int rounds = (sc.n_lights + 31) / 32;
  const int width = (sc.n_lights + rounds - 1) / rounds;
  for (int l0 = 0; s.hval && l0 < sc.n_lights; l0 += RT_LL_CHUNK / 32 * width) {
    const int lc = min(RT_LL_CHUNK / 32 * width, sc.n_lights - l0);
    for (int j0 = 0; j0 < lc; j0 += width) {
      const int j = j0 + lane;
      const bool has = lane < width && j < lc;
      const float* L = tb.lights + (l0 + j) * 8;
      LightRay q = {};
      bool lit = false;
      if (has) {
        q = rt_light_ray(L, p.eps, s.px, s.py, s.pz, s.nx, s.ny, s.nz);
        lit = q.cos_in > 0.0f;  // else intensity and color are exactly 0
      }
      Occl occ = {0.0f, 0.0f, 0.0f, 0.0f, true};
      if (lit) occ = rt_shadow_scan(sc, tb, q.sox, q.soy, q.soz, q.ldx, q.ldy, q.ldz, q.maxd);
      if (has) {
        float t[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        const bool adds = !occ.opq && rt_light_terms(L, q, occ.dec, occ.fr, occ.fg, occ.fb, s.nx,
                                                     s.ny, s.nz, s.dx, s.dy, s.dz, s.mcr, s.mcg,
                                                     s.mcb, has_spec, spec_exp, t);
#pragma unroll
        for (int c = 0; c < 6; ++c) sh.terms[c * RT_LL_CHUNK + j] = t[c];
        flags[j] = adds ? 1.0f : 0.0f;
      }
    }
    __syncwarp();  // the chunk's terms are written
    if (adder) {
      const float* tc = sh.terms + lane * RT_LL_CHUNK;
      for (int j = 0; j < lc; ++j)
        if (flags[j] != 0.0f) acc += tc[j];
    }
    __syncwarp();  // the terms are read before the next chunk writes them
  }
  float sums[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) sums[c] = __shfl_sync(RT_WARP, acc, c);
  if (lane == 0) {
    float contrib[3];
    Child rfl, rfr;
    rt_node_epilogue(p, r, s, sums, sums + 3, contrib, &rfl, &rfr);
    store(r, contrib, rfl, rfr);
  }
}

// The node of a ray without a hit (valid = 0): no light reaches it, so its
// lighting is exactly 0 and the node is the epilogue alone.
template <class Store>
__device__ __forceinline__ void rt_node_unlit(const NodeParams& p, int r, Store store) {
  const Surf s = rt_surf(p, r);
  const float zero[3] = {0.0f, 0.0f, 0.0f};
  float contrib[3];
  Child rfl, rfr;
  rt_node_epilogue(p, r, s, zero, zero, contrib, &rfl, &rfr);
  store(r, contrib, rfl, rfr);
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
