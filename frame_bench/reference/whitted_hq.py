"""The plain Whitted reference with anti-aliasing and the quality tiers: the
reference renderer's `high_quality` and `extreme_quality` builds.

It is `whitted.Reference` (the node, the shadow scan, the light cloud, the
encode) with what those builds change, written out anew from the reference
renderer (ref src/renderer/raytracer_renderer.rs:55-127, 876-916,
1001-1015). It imports neither the system under test nor the JAX package.

* Quality tiers (rs:55-87): depths 9/8 at standard quality, 13/18 at high,
  21/21 at extreme; with soft shadows each light becomes a cloud of 10, 19
  or 28 lights (`lights.expand_lights`, the same seed). `extreme_quality`
  implies `high_quality`, which implies anti-aliasing and soft shadows.
* AA samples (rs:105-127, 876-916): a table of `total` rows, the samples a
  pixel rounded up to the 8-wide packet (24 at extreme, 9 -> 16 otherwise):
  [0,0], then 8 x [1,1], then, with randomness, the Poisson points of
  `poisson_disk([1.2, 1.2], 3 / total, 30, seed ^ 0xAA5EED, total - 1)`
  (without it more [1,1] rows). Each row is scaled by the window-to-scene
  factors times sqrt(5)/2.05 under rotation (0.85 without) and by bias
  direction 0 of the eight, the scalar build's: the grid's -y axis, turned
  by atan(1/2) under rotation. A sample moves the ray's origin; its
  direction stays the pixel's, from the focus through the pixel.
* Identical rows are one ray: they are folded into one sample of weight
  count / total (at extreme the eight [1,1] rows, so 17 rays a pixel). By
  linearity this is exact; `dedupe=False` traces every row.
* Each sample is traced with path weight 1, so that the weight cutoff acts
  on path weights alone; after tracing a pixel is the sum over its samples
  that hit something of weight x colour, then clamped and encoded, and 0
  only where no sample hit (rs:1001-1015).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import whitted
from .lights import expand_lights, poisson_disk

AA_KEYS = ("anti_aliasing", "anti_aliasing_rotation_scale", "anti_aliasing_randomness")
QUALITY_KEYS = ("high_quality", "extreme_quality")


def tiers(render: dict) -> dict:
    """The build's flags after the reference's implications (rs:55-93)."""
    extreme = bool(render.get("extreme_quality"))
    high = extreme or bool(render.get("high_quality"))
    aa = high or any(bool(render.get(k)) for k in AA_KEYS)
    soft = high or bool(render.get("soft_shadows"))
    return dict(
        extreme=extreme, high=high, aa=aa, soft=soft,
        depths=(21, 21) if extreme else (13, 18) if high else (9, 8),
        per_light=(28 if extreme else 19 if high else 10) if soft else 1,
        samples=24 if extreme else 9,
    )


def aa_offsets(render: dict, width: int, height: int, seed: int):
    """The AA origin offsets (total, 3) float32 in scene units, one row per
    sample of the table; None without AA."""
    t = tiers(render)
    if not t["aa"]:
        return None
    rotation = bool(render.get("anti_aliasing_rotation_scale"))
    total = -(-t["samples"] // 8) * 8
    rows = [[0.0, 0.0]] + [[1.0, 1.0]] * 8
    if render.get("anti_aliasing_randomness"):
        rows += poisson_disk([1.2, 1.2], 3.0 / total, 30, seed ^ 0xAA5EED, total - 1).tolist()
    else:
        rows += [[1.0, 1.0]] * total
    table = np.asarray(rows[:total], np.float32)
    scale = math.sqrt(5.0) / 2.05 if rotation else 0.85
    angle = math.atan(0.5) if rotation else 0.0
    up = np.array([math.sin(angle), -math.cos(angle), 0.0])  # the grid's -y axis
    bias = (up / np.linalg.norm(up)).astype(np.float32)
    out = np.zeros((total, 3), np.float32)
    out[:, 0] = table[:, 0] * (1.0 / width) * scale * bias[0]
    out[:, 1] = table[:, 1] * ((height / width) / height) * scale * bias[1]
    return out


def fold(offsets: np.ndarray):
    """(distinct rows (U, 3), weights (U,) float32 = count / total)."""
    rows, counts = np.unique(offsets, axis=0, return_counts=True)
    return rows.astype(np.float32), (counts / offsets.shape[0]).astype(np.float32)


class Reference(whitted.Reference):
    """The scene of one run with its AA samples, ready to render on `device`
    in `dtype`."""

    def __init__(self, raw: dict, render: dict, width: int, height: int, seed: int,
                 device, dtype=torch.float32, pair_budget: int = 2**25, dedupe: bool = True):
        if int(render.get("aa_packet_lanes", 1)) != 1:
            raise ValueError("the reference renders the scalar build's AA (aa_packet_lanes 1)")
        base = {k: v for k, v in render.items() if k not in AA_KEYS + QUALITY_KEYS}
        super().__init__(raw, base, width, height, seed, device, dtype, pair_budget)
        t = tiers(render)
        self.refl_max, self.refr_max = t["depths"]
        lp, lc, li = expand_lights(raw["lights"], t["per_light"], self.w2s, seed)
        self.lpos, self.lcol, self.lint = (torch.as_tensor(a, dtype=dtype, device=self.dev)
                                           for a in (lp, lc, li))
        self.chunk = max(1024, pair_budget // (self.n_obj * min(max(lp.shape[0], 1), 8)))
        offsets = aa_offsets(render, width, height, seed)
        if offsets is None:
            offsets, weights = np.zeros((1, 3), np.float32), np.ones((1,), np.float32)
        elif dedupe:
            offsets, weights = fold(offsets)
        else:
            weights = np.full((offsets.shape[0],), 1.0 / offsets.shape[0], np.float32)
        self.offsets = torch.as_tensor(offsets, dtype=dtype, device=self.dev)
        self.weights = torch.as_tensor(weights, dtype=dtype, device=self.dev)

    def render(self, block_rays: int = 2**22):
        """(colour (H*W, 3) float32, hit (H*W,) bool) on the CPU, row-major:
        every sample of a block of pixels traced generation by generation,
        then each pixel's samples reduced."""
        HW, U = self.H * self.W, self.offsets.shape[0]
        dev, dt = self.dev, self.dt
        accum = torch.zeros((HW * U, 3), dtype=dt, device=dev)
        hit = torch.zeros((HW * U,), dtype=torch.bool, device=dev)
        focus = torch.tensor(self.focus, dtype=dt, device=dev)
        sample = torch.arange(U, device=dev)
        per_block = max(1, block_rays // U)
        for start in range(0, HW, per_block):
            pix = torch.arange(start, min(start + per_block, HW), device=dev)
            xy = torch.stack([(pix % self.W).to(dt) * self.w2s[0],
                              torch.div(pix, self.W, rounding_mode="floor").to(dt) * self.w2s[1],
                              torch.zeros(pix.shape, dtype=dt, device=dev)], -1)
            n = pix.shape[0] * U
            rays = dict(o=(xy[:, None, :] + self.offsets[None]).reshape(n, 3),
                        d=whitted._normalize(xy - focus)[:, None, :].expand(-1, U, 3).reshape(n, 3),
                        ior=torch.full((n,), whitted.AIR, dtype=dt, device=dev),
                        w=torch.ones((n, 3), dtype=dt, device=dev),
                        budget=torch.full((n,), -1, dtype=torch.int32, device=dev),
                        refl=torch.zeros((n,), dtype=torch.bool, device=dev),
                        pix=(pix[:, None] * U + sample[None]).reshape(n))
            primary = True
            while rays and rays["pix"].shape[0]:
                nxt = []
                for s in range(0, rays["pix"].shape[0], self.chunk):
                    part = {k: v[s:s + self.chunk] for k, v in rays.items()}
                    contrib, hval, kids = self._node(part)
                    accum.index_add_(0, part["pix"], contrib)
                    if primary:
                        hit[part["pix"]] = hval
                    if kids:
                        nxt.append(kids)
                rays = {k: torch.cat([c[k] for c in nxt]) for k in nxt[0]} if nxt else {}
                primary = False
        hit = hit.view(HW, U)
        color = torch.where(hit[..., None], accum.view(HW, U, 3), torch.zeros((), dtype=dt, device=dev))
        color = (color * self.weights[None, :, None]).sum(1)
        return color.float().cpu(), hit.any(1).cpu()


def reference_frame(raw, render, width, height, seed, device, dtype=torch.float32):
    """The frame as (H*W,) uint32 pixels, row-major."""
    ref = Reference(raw, render, width, height, seed, device, dtype)
    return whitted.encode_u32(*ref.render())
