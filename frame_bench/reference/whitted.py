"""A plain Whitted renderer in PyTorch: the benchmark's reference.

Straight tensor code, computed in blocks of pixels and generations of rays,
in the precision it is given (float32 as the configurations state it; the
control runs it in bfloat16). It imports neither the system under test nor
the JAX package, and takes nothing that either has made: it works out the
triangles, normals, culling and light clouds from the raw scene
(`geometry.py`, `lights.py`).

The semantics are the reference renderer's (ref src/renderer/
raytracer_renderer.rs:147-874, raytracing/raytracer.rs:24-220, the primitive
intersections, material.rs:467-525, light.rs:261-300), with the
configuration's tree as a wavefront of weighted rays, as the configuration
states it:
* a primary ray per pixel from the focus through (px * w2s_w, py * w2s_h, 0);
* nearest hit over spheres (the nearest root with t >= 0) and triangles
  (t > eps, u, v >= 0, u + v < 1, |det| > eps);
* at a hit: ambient colour * 0.08, then per light a shadow ray from the
  point moved eps_dist towards the light, through transmissive occluders
  (opacity falls by 1 - opacity * Fresnel transmittance per occluder, the
  colour filter by the occluder's absorption; any opaque occluder blocks
  the light), the tanh-sigmoid light attenuation, Lambert and the
  reference's specular term; direct and specular light scaled by the
  distance attenuation 1 / (1 + t + 0.1 t^2); a transmissive surface drops
  its direct light;
* a ray's weight is the product of the Fresnel reflectances, transmittances
  and boosts along its path, times the distance attenuation of its hit when
  it is a reflection; a child is traced when its largest weight channel
  exceeds `weight_cutoff` and its depth budget stays above 0 (reflections
  9, refractions 8 divided by 1-3 by opacity, then 1 or 2 per step);
* the pixel is the sum of its tree's contributions, encoded as
  round-half-up(clamp(c) * 255) in 0xFFRRGGBB, 0 where the primary ray
  missed.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import F32_EPS, prepare
from .lights import expand_lights

AIR = 1.000293  # the refraction index of air (ref src/lib.rs:92)
INF = float("inf")


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _reflect(v, n):
    return v - 2.0 * _dot(v, n)[..., None] * n


def _attenuation(t):
    t = torch.abs(t)
    return torch.clamp(1.0 / (1.0 + t + 0.1 * t * t), 0.0, 1.0)


def _fresnel(normal, view, other_ior, color, metallic, ior, trans):
    """Schlick Fresnel with metallic-tinted F0, total internal reflection and
    the non-transmissive early out F = metallic (ref material.rs:467-525).
    Returns F (N, 3)."""
    n_dot_v = _dot(normal, view)
    cos_t = torch.abs(n_dot_v)
    inside = n_dot_v < 0.0
    eta_t = torch.where(inside, ior / other_ior, other_ior / ior)
    sin2_t = eta_t * eta_t * (1.0 - cos_t * cos_t)
    reflective = metallic > 0.0
    tir = (trans & inside & (sin2_t > 1.0)) | reflective
    f0 = ((other_ior - ior) / (other_ior + ior)) ** 2
    f0 = f0[:, None] + (color - f0[:, None]) * metallic[:, None]
    fres = f0 + (1.0 - f0) * ((1.0 - cos_t) ** 5)[:, None]
    amount = torch.where(reflective, metallic, torch.ones_like(metallic))
    f = torch.where(tir[:, None], amount[:, None].expand_as(fres), fres)
    return torch.where(trans[:, None], f, metallic[:, None].expand_as(f))


class Reference:
    """The scene of one run, ready to render on `device` in `dtype`."""

    def __init__(self, raw: dict, render: dict, width: int, height: int, seed: int,
                 device, dtype=torch.float32, pair_budget: int = 2**25):
        unsupported = [k for k in ("anti_aliasing", "anti_aliasing_rotation_scale",
                                   "anti_aliasing_randomness", "backface_culling",
                                   "high_quality", "extreme_quality", "packet_mode")
                       if render.get(k)]
        if unsupported:
            raise ValueError(f"the reference does not render {unsupported}")
        self.W, self.H = width, height
        self.dev, self.dt = torch.device(device), dtype
        self.pair_budget = pair_budget
        self.reflections = bool(render.get("reflections"))
        self.refractions = bool(render.get("refractions"))
        self.cutoff = float(render["weight_cutoff"])
        self.refl_max, self.refr_max = 9, 8  # raytracer_renderer.rs:55-73, standard quality
        aspect = height / width
        depth = (1.0 + aspect) / 2.0
        avg = (1.0 + aspect + depth) / 3.0
        self.w2s = (1.0 / width, aspect / height, depth / ((width + height) // 2))
        self.focus = (0.5, aspect / 2.0, -1.9 * depth)
        self.eps = F32_EPS * 100.0 * avg  # ref vector.rs:697-699

        prep = prepare(raw, bool(render.get("scene_backface_culling")))
        per_light = 10 if render.get("soft_shadows") else 1  # raytracer_renderer.rs:75-87
        lp, lc, li = expand_lights(raw["lights"], per_light, self.w2s, seed)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.dev)

        self.sph_c, self.sph_r2 = t(prep["sph"][:, :3]), t(prep["sph"][:, 3] ** 2)
        v = prep["tri"]
        self.v0, self.e1, self.e2 = t(v[:, 0]), t(v[:, 1] - v[:, 0]), t(v[:, 2] - v[:, 0])
        self.tri_n = t(prep["tri_n"])
        mats = np.concatenate([prep["sph_mat"], prep["tri_mat"]])
        self.mat = t(mats)
        self.trans = torch.as_tensor(mats[:, 7] != 0, device=self.dev)
        absorb_op = np.clip(np.where(mats[:, 7] != 0, mats[:, 6], 1.0), 0.0, 1.0 - F32_EPS)
        self.absorb = t(mats[:, 0:3] * (1.0 - absorb_op)[:, None])
        self.lpos, self.lcol, self.lint = t(lp), t(lc), t(li)
        self.n_sph = self.sph_c.shape[0]
        self.n_obj = self.n_sph + self.v0.shape[0]
        # rays per node batch: its shadow rays of up to 8 lights at a time
        # against every object stay within `pair_budget` pair tests
        self.chunk = max(1024, pair_budget // (self.n_obj * min(max(lp.shape[0], 1), 8)))

    # ---- intersections -------------------------------------------------
    def _sphere_t(self, o, d):
        """(N, S) distances with the nearest-root-first rule, inf on a miss."""
        oc = o[:, None, :] - self.sph_c[None]
        b = 2.0 * _dot(d[:, None, :], oc)
        c = _dot(oc, oc) - self.sph_r2[None]
        disc = b * b - 4.0 * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = (-b - sq) * 0.5, (-b + sq) * 0.5
        ok = disc >= 0.0
        t0v, t1v = ok & (t0 >= 0.0), ok & (t1 >= 0.0)
        use0 = t0v & (~t1v | (t0 < t1))
        use1 = t1v & ~use0
        inf = torch.full_like(t0, INF)
        return torch.where(use0, t0, torch.where(use1, t1, inf))

    def _triangle_t(self, o, d):
        """(N, T) Moller-Trumbore distances, inf on a miss."""
        p = _cross(d[:, None, :], self.e2[None])
        det = _dot(self.e1[None], p)
        inv = 1.0 / det
        s = o[:, None, :] - self.v0[None]
        u = _dot(s, p) * inv
        q = _cross(s, self.e1[None].expand_as(s))
        v = _dot(d[:, None, :], q) * inv
        t = _dot(self.e2[None], q) * inv
        ok = (torch.abs(det) > F32_EPS) & (t > F32_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v < 1.0)
        return torch.where(ok, t, torch.full_like(t, INF))

    def _object_t(self, o, d):
        return torch.cat([self._sphere_t(o, d), self._triangle_t(o, d)], 1)

    def _occlusion(self, o, d, max_d):
        """Per shadow ray: (blocked by an opaque occluder, combined opacity,
        colour filter (N, 3)) over every object within max_d
        (ref raytracer.rs:24-106)."""
        t = self._object_t(o, d)
        hit = torch.isfinite(t) & (t <= max_d[:, None])
        # the occluder's normal at its hit; Fresnel sees view = -direction
        ts = torch.where(hit[:, : self.n_sph], t[:, : self.n_sph], torch.zeros_like(t[:, : self.n_sph]))
        n_sph = _normalize(o[:, None, :] + d[:, None, :] * ts[..., None] - self.sph_c[None])
        cos_nv = -torch.cat([_dot(d[:, None, :], n_sph), _dot(d[:, None, :], self.tri_n[None])], 1)
        m = self.mat
        ior, op, met, col_r = m[:, 5][None], m[:, 6][None], m[:, 3][None], m[:, 0][None]
        trans = self.trans[None]
        cos_t = torch.abs(cos_nv)
        inside = cos_nv < 0.0
        eta_t = torch.where(inside, ior.expand_as(cos_nv), 1.0 / ior)
        sin2_t = eta_t * eta_t * (1.0 - cos_t * cos_t)
        reflective = met > 0.0
        tir = (trans & inside & (sin2_t > 1.0)) | reflective
        f0 = ((1.0 - ior) / (1.0 + ior)) ** 2
        f0r = f0 + (col_r - f0) * met
        fres = f0r + (1.0 - f0r) * (1.0 - cos_t) ** 5
        amount = torch.where(reflective, met, torch.ones_like(met))
        f_r = torch.where(trans, torch.where(tir, amount.expand_as(fres), fres), met)
        io = torch.where(trans, op * (1.0 - f_r), torch.zeros_like(f_r))
        zero = torch.zeros_like(io)
        dec = torch.where(hit, 1.0 - io, zero).sum(1)
        opaque = (hit & ~trans).any(1)
        fsub = (hit.to(self.dt)[..., None] * self.absorb[None]).sum(1)
        return opaque, torch.clamp(1.0 - dec, 0.0, 1.0), 1.0 - fsub

    # ---- one shading-tree node for N rays --------------------------------
    def _lighting(self, p, n, view, color, shin, hval):
        """(direct incl. ambient, specular), each (N, 3)
        (ref raytracer_renderer.rs:731-874, light.rs:261-300)."""
        N, L = p.shape[0], self.lpos.shape[0]
        direct = torch.where(hval[:, None], color, torch.zeros_like(color)) * 0.08
        spec_sum = torch.zeros_like(direct)
        has_spec = shin > 0.0
        spec_exp = torch.clamp(shin * 512.0, min=1.0)
        group = max(1, min(L, self.pair_budget // max(N * self.n_obj, 1)))
        for l0 in range(0, L, group):
            lpos, lcol, lint = self.lpos[l0:l0 + group], self.lcol[l0:l0 + group], self.lint[l0:l0 + group]
            g = lpos.shape[0]
            ltp = lpos[None] - p[:, None, :]  # (N, g, 3)
            ldir = _normalize(ltp)
            so = p[:, None, :] + ldir * self.eps
            max_d = torch.sqrt(_dot(lpos[None] - so, lpos[None] - so))
            opaque, opacity, filt = self._occlusion(so.reshape(-1, 3), ldir.reshape(-1, 3),
                                                    max_d.reshape(-1))
            opaque, opacity, filt = opaque.view(N, g), opacity.view(N, g), filt.view(N, g, 3)
            reach = ~opaque & hval[:, None]
            dist = torch.sqrt(_dot(ltp, ltp)) + F32_EPS
            cos_in = _dot(ltp, n[:, None, :]) / dist
            facing = cos_in > 0.0
            att = 0.95 * (F32_EPS + dist + dist * dist)
            sig = torch.clamp((torch.tanh(att) + 1.0) / 2.0, 0.0, 1.0)
            zero = torch.zeros_like(cos_in)
            c_int = torch.where(facing, cos_in * lint[None] * sig, zero)
            c_col = torch.where(facing[..., None], color[:, None, :] * lcol[None],
                                torch.zeros_like(ltp))
            l_col = torch.where(reach[..., None], c_col / filt, c_col)
            diffuse = torch.clamp(_dot(n[:, None, :], ldir), min=0.0)
            sdir = _normalize(_reflect(ldir, n[:, None, :]))
            spec = torch.clamp(_dot(sdir, view[:, None, :]), min=0.0) ** spec_exp[:, None]
            spec = torch.where(has_spec[:, None], spec, zero)
            op_sel = torch.where(reach, opacity, torch.ones_like(opacity))
            lit = (diffuse > 0.0) & reach
            d_term = color[:, None, :] * l_col * (diffuse * c_int * op_sel)[..., None]
            s_term = lcol[None] * (c_int * op_sel * spec)[..., None]
            direct = direct + torch.where(lit[..., None], d_term, torch.zeros_like(d_term)).sum(1)
            s_on = (lit & has_spec[:, None])[..., None]
            spec_sum = spec_sum + torch.where(s_on, s_term, torch.zeros_like(s_term)).sum(1)
        return direct, spec_sum

    def _node(self, r):
        """Contribution (N, 3), primary-hit mask (N,), children (a ray dict)."""
        o, d, ior, w, budget, refl = r["o"], r["d"], r["ior"], r["w"], r["budget"], r["refl"]
        t_all = self._object_t(o, d)
        t, idx = torch.min(t_all, 1)
        hval = torch.isfinite(t)
        t = torch.where(hval, t, torch.zeros_like(t))
        p = o + d * t[:, None]
        sph = idx < self.n_sph
        c_idx = torch.clamp(idx, max=self.n_sph - 1)
        t_idx = torch.clamp(idx - self.n_sph, min=0)
        n = torch.where(sph[:, None], _normalize(p - self.sph_c[c_idx]), self.tri_n[t_idx])
        m = self.mat[idx]
        color, metallic, shin, h_ior, opac, boost = (m[:, 0:3], m[:, 3], m[:, 4], m[:, 5],
                                                     m[:, 6], m[:, 8])
        trans = self.trans[idx]

        direct, spec = self._lighting(p, n, d, color, shin, hval)
        att = torch.where(hval, _attenuation(t), torch.zeros_like(t))
        wn = w * torch.where(refl, att, torch.ones_like(att))[:, None]
        node_col = torch.where(trans[:, None], torch.zeros_like(direct), direct * att[:, None])
        node_col = node_col + spec * att[:, None]
        contrib = torch.where(hval[:, None], wn * node_col, torch.zeros_like(wn))

        kids = []
        cos_theta = _dot(d, n)
        air = torch.full_like(ior, AIR)
        if self.reflections:  # raytracer_renderer.rs:526-729
            inside = cos_theta < 0.0
            inormal = torch.where(inside[:, None], -n, n)
            new_ior = torch.where(inside, h_ior, air)
            eta = torch.where(inside, new_ior / ior, ior / new_ior)
            sin2_t = eta * eta * (1.0 - cos_theta * cos_theta)
            reflective = (metallic > 0.0) | (trans & (sin2_t >= 1.0))
            rdir = _normalize(_reflect(d, n))
            rw = wn * _fresnel(inormal, -d, ior, color, metallic, h_ior, trans)
            rb = torch.where(budget < 0, torch.full_like(budget, self.refl_max),
                             torch.clamp(budget - 1, min=0))
            keep = hval & reflective & (rb > 0) & (rw.amax(1) > self.cutoff)
            kids.append(dict(o=p + rdir * self.eps, d=rdir, ior=ior, w=rw, budget=rb,
                             refl=torch.ones_like(keep), pix=r["pix"], keep=keep))
        if self.refractions:  # raytracer_renderer.rs:279-524
            inside = cos_theta <= 0.0
            inormal = torch.where(inside[:, None], -n, n)
            new_ior = torch.where(inside, h_ior, air)
            eta = torch.where(inside, new_ior / ior, ior / new_ior)
            inv_eta = 1.0 / eta
            tw = 1.0 - _fresnel(inormal, d, inv_eta, color, metallic, h_ior, trans)
            # GLSL refract of d about -inormal; k < 0 leaves no ray
            nn = -inormal
            ndi = _dot(nn, d)
            k = 1.0 - inv_eta * inv_eta * (1.0 - ndi * ndi)
            raw = d * inv_eta[:, None] - (inv_eta * ndi + torch.sqrt(torch.clamp(k, min=0.0)))[:, None] * nn
            k_ok = k >= 0.0
            tdir = torch.where(k_ok[:, None], _normalize(raw), torch.zeros_like(raw))
            op = torch.where(trans, opac, torch.zeros_like(opac))
            one = torch.ones_like(budget)
            step = torch.where(op < 0.5, 2 * one, one)
            div = torch.where(op <= 0.3, 3 * one, torch.where(op < 0.5, 2 * one, one))
            tb = torch.where(budget < 0, self.refr_max // div, torch.clamp(budget - step, min=0))
            boost_f = torch.where(trans, boost, torch.zeros_like(boost)) + 1.0
            tw = wn * tw * boost_f[:, None]
            keep = hval & trans & (tb > 0) & k_ok & (tw.amax(1) > self.cutoff)
            kids.append(dict(o=p + tdir * self.eps, d=tdir, ior=new_ior, w=tw, budget=tb,
                             refl=torch.zeros_like(keep), pix=r["pix"], keep=keep))
        children = {}
        if kids:
            for key in ("o", "d", "ior", "w", "budget", "refl", "pix"):
                children[key] = torch.cat([kd[key][kd["keep"]] for kd in kids])
        return contrib, hval, children

    # ---- the frame -------------------------------------------------------
    def render(self, block_pixels: int = 2**18):
        """(colour (H*W, 3) float32, hit (H*W,) bool) on the CPU, row-major."""
        HW = self.H * self.W
        dev, dt = self.dev, self.dt
        accum = torch.zeros((HW, 3), dtype=dt, device=dev)
        valid = torch.zeros((HW,), dtype=torch.bool, device=dev)
        focus = torch.tensor(self.focus, dtype=dt, device=dev)
        for start in range(0, HW, block_pixels):
            pix = torch.arange(start, min(start + block_pixels, HW), device=dev)
            o = torch.stack([(pix % self.W).to(dt) * self.w2s[0],
                             torch.div(pix, self.W, rounding_mode="floor").to(dt) * self.w2s[1],
                             torch.zeros(pix.shape, dtype=dt, device=dev)], -1)
            n = pix.shape[0]
            rays = dict(o=o, d=_normalize(o - focus), ior=torch.full((n,), AIR, dtype=dt, device=dev),
                        w=torch.ones((n, 3), dtype=dt, device=dev),
                        budget=torch.full((n,), -1, dtype=torch.int32, device=dev),
                        refl=torch.zeros((n,), dtype=torch.bool, device=dev), pix=pix)
            primary = True
            while rays and rays["pix"].shape[0]:
                nxt = []
                for s in range(0, rays["pix"].shape[0], self.chunk):
                    part = {k: v[s:s + self.chunk] for k, v in rays.items()}
                    contrib, hval, kids = self._node(part)
                    accum.index_add_(0, part["pix"], contrib)
                    if primary:
                        valid[part["pix"]] = hval
                    if kids:
                        nxt.append(kids)
                rays = {k: torch.cat([c[k] for c in nxt]) for k in nxt[0]} if nxt else {}
                primary = False
        return accum.float().cpu(), valid.cpu()


def encode_u32(color: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """0xFFRRGGBB of round-half-up(clamp(c) * 255), 0 where nothing was hit."""
    c = torch.nan_to_num(color.float(), nan=0.0, posinf=1.0, neginf=0.0)
    u8 = torch.floor(torch.clamp(c, 0.0, 1.0) * 255.0 + 0.5).to(torch.int64)
    px = (0xFF << 24) | (u8[:, 0] << 16) | (u8[:, 1] << 8) | u8[:, 2]
    return torch.where(valid, px, torch.zeros_like(px)).numpy().astype(np.uint32)


def reference_frame(raw, render, width, height, seed, device, dtype=torch.float32):
    """The frame as (H*W,) uint32 pixels, row-major."""
    ref = Reference(raw, render, width, height, seed, device, dtype)
    return encode_u32(*ref.render())

