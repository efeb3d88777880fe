// Fused shading + shading-tree node evaluation with packed pool rows, for
// the PyTorch port (sm_90a).
//
// Replaces: hslu_i/ba_raytracing/f2501_raytracer_tpu/ops/pallas_kernels.py
//   `_shade_eval_kernel(packed_rows=True)` (line 1858) behind
//   `pallas_shade_eval_rows` (line 2250), with its shadow scan
//   (`_light_sums` 1662, `_sphere_occl_comp` 803, `_bigtri_occl_split`
//   1188, `_tri_occl_lights_lanegate` / `_tri_occl_lights` 1370 / 1519).
//
// What it computes, per ray: ambient + direct + specular light over all
// lights with the hard-shadow scan (spheres, big primitives, Morton blocks;
// transmissive occluders attenuate through the shadow Fresnel term, opaque
// ones block), the distance attenuation, the transmissive combine rule,
// and the reflection / refraction children (Fresnel, TIR, adaptive depth
// budgets, weight cutoff), written as (R, 16) pool rows
// [o3 | d3 | w3 | ior | budget | from_refl | pix | 0 0 0] plus masks. It
// follows the plain path (ops/shading.py::light_sums + ops/trace.py::
// _node_children + _pack_entry) operation by operation; it does not copy
// the TPU kernel's rescaled-parameter pair math.
//
// What bounds it on this card: operations. Each (ray, light, triangle)
// shadow pair costs ~40-70 f32 operations; inputs and outputs are ~200 B
// per ray. At 1080p semesterbild (5 lights, 9 spheres, 48 big triangles,
// 2 blocks of 64) a lit ray tests up to ~1100 pairs.
//
// Design: one thread per ray. The small tables (lights, spheres, big
// primitives: a few KB) are staged in shared memory; the Morton block pack
// is read from global memory (L1/L2-resident, every lane of a warp reads
// the same row), so the real text mesh (~1.9 MB of blocks) also works.
// Blocks are skipped by the widened AABB gate (rt_common.cuh), and a
// light's scan stops as soon as an opaque occluder is found: that is exact,
// because an occluded light contributes nothing (can_reach is false and
// every term that reads the shadow sums is discarded). Lights behind the
// surface (cos_in <= 0) contribute exactly zero and skip the scan too.
#include "rt_common.cuh"

namespace {

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

struct Params {
  const float *lights, *sph, *trb, *blk, *blk_aabb;
  int n_lights, S, P, trans_rows, nb, B, n_trans_blocks, smem_tables;
  const float *point, *normal, *view, *color, *shin, *valid, *t, *w, *rior;
  const int* budget;
  const float *frefl, *httr, *met, *hior, *opac, *boost;
  const int* pix;
  int R;
  float eps, weight_cutoff, air;
  int backface, reflections, refractions, refl_max, refr_max;
  float *contrib, *rfl_rows, *rfr_rows;
  unsigned char *rfl_m, *rfr_m;
};

// Full shadow scan for one light; returns the totals (opq set => the rest
// was skipped and the sums are not used)
__device__ Occl shadow_scan(const Params& p, const float* __restrict__ sph,
                            const float* __restrict__ trb, float sox, float soy,
                            float soz, float ldx, float ldy, float ldz, float maxd) {
  const bool bf = p.backface != 0;
  Occl tot = {0.0f, 0.0f, 0.0f, 0.0f, false};
  // spheres (JAX intersect.py::_sphere_occlusion)
  for (int s = 0; s < p.S; ++s) {
    const float* q = sph + s * 16;
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
    for (int r = 0; r < p.P && !part.opq; ++r)
      occl_tri(trb + r * 32, sox, soy, soz, ldx, ldy, ldz, maxd, bf, r < p.trans_rows, &part);
    add_part(&tot, part);
  }
  if (tot.opq) return tot;
  // Morton blocks (transmissive blocks first), behind the block gate
  const float ix = 1.0f / ldx, iy = 1.0f / ldy, iz = 1.0f / ldz;
  for (int b = 0; b < p.nb; ++b) {
    if (!rt_gate(p.blk_aabb + b * 8, sox, soy, soz, ix, iy, iz, maxd)) continue;
    const float* blk = p.blk + (size_t)b * p.B * 32;
    const bool trans = b < p.n_trans_blocks;
    Occl part = {0.0f, 0.0f, 0.0f, 0.0f, false};
    for (int c = 0; c < p.B && !part.opq; ++c)
      occl_tri(blk + c * 32, sox, soy, soz, ldx, ldy, ldz, maxd, bf, trans, &part);
    add_part(&tot, part);
    if (tot.opq) return tot;
  }
  return tot;
}

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

__device__ __forceinline__ void store_row(float* rows, int r, const float* v) {
  float4* dst = reinterpret_cast<float4*>(rows + (size_t)r * 16);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  dst[2] = make_float4(v[8], v[9], v[10], v[11]);
  dst[3] = make_float4(v[12], v[13], v[14], v[15]);
}

__global__ void shade_eval_rows_kernel(Params p) {
  extern __shared__ float smem[];
  const float* lights = p.lights;
  const float* sph = p.sph;
  const float* trb = p.trb;
  if (p.smem_tables) {
    const int nl = p.n_lights * 8, ns = p.S * 16, nt = p.P * 32;
    for (int i = threadIdx.x; i < nl + ns + nt; i += blockDim.x)
      smem[i] = i < nl ? p.lights[i] : (i < nl + ns ? p.sph[i - nl] : p.trb[i - nl - ns]);
    __syncthreads();
    lights = smem;
    sph = smem + nl;
    trb = smem + nl + ns;
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;

  const bool hval = p.valid[r] != 0.0f;
  const float px = p.point[3 * r], py = p.point[3 * r + 1], pz = p.point[3 * r + 2];
  const float nx = p.normal[3 * r], ny = p.normal[3 * r + 1], nz = p.normal[3 * r + 2];
  const float dx = p.view[3 * r], dy = p.view[3 * r + 1], dz = p.view[3 * r + 2];
  const float mcr = p.color[3 * r], mcg = p.color[3 * r + 1], mcb = p.color[3 * r + 2];
  const float shin = p.shin[r];

  // ---- lighting (ops/shading.py::light_sums) ----
  float lr = 0.0f, lg = 0.0f, lb = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
  if (hval) {
    const bool has_spec = shin > 0.0f;
    const float spec_exp = fmaxf(shin * 512.0f, 1.0f);
    for (int l = 0; l < p.n_lights; ++l) {
      const float* L = lights + l * 8;
      const float ltx = L[0] - px, lty = L[1] - py, ltz = L[2] - pz;
      const float lt2 = (ltx * ltx + lty * lty) + ltz * ltz;
      const float inv_lt = 1.0f / sqrtf(lt2);
      const float ldx = ltx * inv_lt, ldy = lty * inv_lt, ldz = ltz * inv_lt;
      const float sox = px + ldx * p.eps, soy = py + ldy * p.eps, soz = pz + ldz * p.eps;
      const float dex = L[0] - sox, dey = L[1] - soy, dez = L[2] - soz;
      const float maxd = sqrtf((dex * dex + dey * dey) + dez * dez);
      // PointLight::calculate_contribution_at (light.rs:261-300)
      const float ldist = sqrtf(lt2) + RT_EPS;
      const float cos_in = ((ltx * nx + lty * ny) + ltz * nz) / ldist;
      if (!(cos_in > 0.0f)) continue;  // intensity and color are exactly 0
      const Occl occ = shadow_scan(p, sph, trb, sox, soy, soz, ldx, ldy, ldz, maxd);
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
  const float amb = hval ? 0.08f : 0.0f;
  float dir[3] = {mcr * amb + lr, mcg * amb + lg, mcb * amb + lb};
  float spc[3] = {sr, sg, sb};

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
    p.contrib[3 * r + k] = hval ? w[k] * node : 0.0f;
  }

  const float met = p.met[r], hior = p.hior[r], rior = p.rior[r];
  const int budget = p.budget[r];
  const float pixf = (float)p.pix[r];
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
    const float rdx = rx * inv, rdy = ry * inv, rdz = rz * inv;
    float F[3];
    fresnel3(inx, iny, inz, -dx, -dy, -dz, rior, hior, met, httr, mcr, mcg, mcb, F);
    const int cb = budget < 0 ? p.refl_max : max(budget - 1, 0);
    const float rw[3] = {w[0] * F[0], w[1] * F[1], w[2] * F[2]};
    const bool mask = hval && reflective && (cb > 0) && above_cutoff(rw, p.weight_cutoff);
    const float row[16] = {px + rdx * p.eps, py + rdy * p.eps, pz + rdz * p.eps,
                           rdx, rdy, rdz, rw[0], rw[1], rw[2], rior, (float)cb, 1.0f,
                           pixf, 0.0f, 0.0f, 0.0f};
    store_row(p.rfl_rows, r, row);
    p.rfl_m[r] = mask;
  } else {
    const float row[16] = {0};
    store_row(p.rfl_rows, r, row);
    p.rfl_m[r] = 0;
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
    const float tdx = k_pos ? qx * inv : 0.0f;
    const float tdy = k_pos ? qy * inv : 0.0f;
    const float tdz = k_pos ? qz * inv : 0.0f;
    const float op = httr ? p.opac[r] : 0.0f;
    const int step = op < 0.5f ? 2 : 1;
    const int divisor = op <= 0.3f ? 3 : (op < 0.5f ? 2 : 1);
    const int cb = budget < 0 ? p.refr_max / divisor : max(budget - step, 0);
    const float boost_f = (httr ? p.boost[r] : 0.0f) + 1.0f;
    const float tw[3] = {w[0] * (1.0f - F[0]) * boost_f, w[1] * (1.0f - F[1]) * boost_f,
                         w[2] * (1.0f - F[2]) * boost_f};
    const bool mask =
        hval && httr && (cb > 0) && k_pos && above_cutoff(tw, p.weight_cutoff);
    const float row[16] = {px + tdx * p.eps, py + tdy * p.eps, pz + tdz * p.eps,
                           tdx, tdy, tdz, tw[0], tw[1], tw[2], new_ior, (float)cb, 0.0f,
                           pixf, 0.0f, 0.0f, 0.0f};
    store_row(p.rfr_rows, r, row);
    p.rfr_m[r] = mask;
  } else {
    const float row[16] = {0};
    store_row(p.rfr_rows, r, row);
    p.rfr_m[r] = 0;
  }
}

}  // namespace

extern "C" int rt_shade_eval_rows(
    const float* lights, int n_lights, const float* sph, int S, const float* trb, int P,
    int trans_rows, const float* blk, const float* blk_aabb, int nb, int B,
    int n_trans_blocks, const float* point, const float* normal, const float* view,
    const float* color, const float* shin, const float* valid, const float* t,
    const float* w, const float* rior, const int* budget, const float* frefl,
    const float* httr, const float* met, const float* hior, const float* opac,
    const float* boost, const int* pix, int R, float eps, int backface, int reflections,
    int refractions, int refl_max, int refr_max, float weight_cutoff, float air,
    float* contrib, float* rfl_rows, unsigned char* rfl_m, float* rfr_rows,
    unsigned char* rfr_m, void* stream) {
  Params p;
  p.lights = lights; p.sph = sph; p.trb = trb; p.blk = blk; p.blk_aabb = blk_aabb;
  p.n_lights = n_lights; p.S = S; p.P = P; p.trans_rows = trans_rows;
  p.nb = nb; p.B = B; p.n_trans_blocks = n_trans_blocks;
  p.point = point; p.normal = normal; p.view = view; p.color = color; p.shin = shin;
  p.valid = valid; p.t = t; p.w = w; p.rior = rior; p.budget = budget;
  p.frefl = frefl; p.httr = httr; p.met = met; p.hior = hior; p.opac = opac;
  p.boost = boost; p.pix = pix; p.R = R; p.eps = eps; p.weight_cutoff = weight_cutoff;
  p.air = air; p.backface = backface; p.reflections = reflections;
  p.refractions = refractions; p.refl_max = refl_max; p.refr_max = refr_max;
  p.contrib = contrib; p.rfl_rows = rfl_rows; p.rfr_rows = rfr_rows;
  p.rfl_m = rfl_m; p.rfr_m = rfr_m;
  // the small tables go to shared memory when they fit the default 48 KB
  const size_t table_bytes = sizeof(float) * ((size_t)n_lights * 8 + (size_t)S * 16 + (size_t)P * 32);
  p.smem_tables = table_bytes <= 48 * 1024;
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    shade_eval_rows_kernel<<<blocks, threads, p.smem_tables ? table_bytes : 0,
                             (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
