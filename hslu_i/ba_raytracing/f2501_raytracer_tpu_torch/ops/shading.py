"""Shading math: Fresnel, direct lighting, distance attenuation.

The port's counterpart of the JAX package's `ops/shading.py` (plain branch).
It keeps the exact (quirky) formulas of the reference's shading pipeline --
these constants and asymmetries define the image and must not be "fixed":

* Schlick Fresnel with metallic-tinted F0, TIR forcing full reflection and
  the non-transmissive early-out F = metallic     (ref material.rs:467-525)
* ambient = material_color * 0.08                 (ref raytracer_renderer.rs:752-764)
* tanh-sigmoid light attenuation with the 0.95 constant (ref light.rs:261-300)
* diffuse multiplies the material color twice     (ref raytracer_renderer.rs:804-851)
* shadowed light color is *divided* by the occluder color filter
  (ref raytracer_renderer.rs:807-811)
* specular = (reflect(L, N)·V)^(max(shininess*512, 1)) -- V pointing at the
  surface, not the halfway vector                 (ref raytracer_renderer.rs:818-833)
* node distance attenuation 1/(1+d+0.1d²)         (ref raytracer_renderer.rs:266-277)

`calculate_lighting` sends the light sums through the `light_shade` kernel
(ops/kernels.py) and adds ambient outside it, as the JAX package does; the
node kernels (`shade_eval`, `shade_eval_rows`) run the same sums inside.
`light_sums` here is the plain twins' lighting part.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..scene.device import DeviceScene
from .intersect import Hit, _where0, occlude_rays, pow2, pow5
from .vecmath import F32_EPSILON, dot, normalized, reflected


def attenuation_factor_based_on_distance(distance):
    """ref raytracer_renderer.rs:266-277."""
    d = torch.abs(distance)
    return torch.clamp(1.0 / (1.0 + d + 0.1 * d * d), 0.0, 1.0)


def compute_fresnel(normal, view_dir, other_ior, color, metallic, ior, has_trans):
    """Schlick Fresnel (ref material.rs:467-525), per-lane scalar semantics.

    Returns (reflectance_rgb, transmittance_rgb = 1 - reflectance).
    Non-transmissive lanes take the early-exit branch: F = metallic.
    """
    is_reflective = metallic > 0.0
    n_dot_v = dot(normal, view_dir)
    cos_theta = torch.abs(n_dot_v)
    is_inside = n_dot_v < 0.0
    eta_t = torch.where(is_inside, ior / other_ior, other_ior / ior)
    sin2_t = eta_t * eta_t * (1.0 - cos_theta * cos_theta)
    is_tir = (has_trans & is_inside & (sin2_t > 1.0)) | is_reflective

    f0 = pow2((other_ior - ior) / (other_ior + ior))
    f0_rgb = f0[..., None] + (color - f0[..., None]) * metallic[..., None]
    fresnel = f0_rgb + (1.0 - f0_rgb) * pow5(1.0 - cos_theta)[..., None]

    reflected_amount = torch.where(
        is_reflective[..., None], metallic[..., None], torch.ones_like(fresnel)
    )
    f = torch.where(is_tir[..., None], reflected_amount, fresnel)
    f = torch.where(has_trans[..., None], f, metallic[..., None].expand_as(f))
    return f, 1.0 - f


def light_sums(light_pack, n_lights: int, sph_pack, trb_pack, tri_blk_pack,
               point, normal, view_dir, color, shininess, valid,
               epsilon_distance: float, backface_culling: bool):
    """Direct and specular light at a hit wavefront, WITHOUT ambient
    (ref raytracer_renderer.rs:731-874), from the kernel-packed scene
    tables; the plain twin of the `light_shade` kernel
    (`pallas_light_shade`). Returns (direct_rgb, specular_rgb), each (R, 3)."""
    R = point.shape[0]
    material_color = color

    has_specular = shininess > 0.0
    spec_exponent = torch.clamp(shininess * 512.0, min=1.0)

    # lights are processed C at a time with ONE occlusion pass per chunk
    # (R*C shadow rays, light-major)
    L = n_lights
    C = max(1, min(L, (2**21) // max(R, 1)))

    light_color = torch.zeros_like(point)
    specular_color = torch.zeros_like(point)

    for start in range(0, L, C):
        end = min(start + C, L)
        c = end - start
        lpos = light_pack[start:end, 0:3]  # (c,3)
        lcolor = light_pack[start:end, 3:6]
        lintensity = light_pack[start:end, 6]

        light_to_point = lpos[:, None, :] - point[None, :, :]  # (C,R,3)
        light_dir = normalized(light_to_point)
        shadow_origin = point[None, :, :] + light_dir * epsilon_distance
        delta = lpos[:, None, :] - shadow_origin
        max_dist = torch.sqrt(dot(delta, delta))  # (C,R)

        occluded, combined_opacity, color_filter = occlude_rays(
            sph_pack, trb_pack, tri_blk_pack,
            shadow_origin.reshape(-1, 3),
            light_dir.reshape(-1, 3),
            max_dist.reshape(-1),
            backface_culling,
        )
        occluded = occluded.reshape(c, R)
        combined_opacity = combined_opacity.reshape(c, R)
        color_filter = color_filter.reshape(c, R, 3)

        can_reach = ~occluded & valid[None, :]

        # PointLight::calculate_contribution_at (light.rs:261-300)
        light_distance = torch.sqrt(dot(light_to_point, light_to_point)) + F32_EPSILON
        cos_in = dot(light_to_point, normal[None, :, :]) / light_distance
        angle_pos = cos_in > 0.0
        att = 0.95 * (F32_EPSILON + light_distance + light_distance * light_distance)
        att_sigmoid = (torch.tanh(att) + 1.0) / 2.0
        contrib_intensity = _where0(
            angle_pos,
            cos_in * lintensity[:, None] * torch.clamp(att_sigmoid, 0.0, 1.0),
        )
        contrib_color = _where0(
            angle_pos[..., None], material_color[None, :, :] * lcolor[:, None, :]
        )  # (C,R,3)

        # shadow filter division quirk (raytracer_renderer.rs:807-811)
        light_color_simd = torch.where(
            can_reach[..., None], contrib_color / color_filter, contrib_color
        )

        diffuse_factor = torch.clamp(dot(normal[None, :, :], light_dir), min=0.0)

        spec_reflect = reflected(light_dir, normal[None, :, :])
        spec = torch.pow(
            torch.clamp(dot(normalized(spec_reflect), view_dir[None, :, :]), min=0.0),
            spec_exponent[None, :],
        )
        specular_factor = _where0(has_specular[None, :], spec)

        opacity_sel = torch.where(
            can_reach, combined_opacity, torch.ones_like(combined_opacity)
        )
        light_factor = diffuse_factor * contrib_intensity * opacity_sel
        spec_factor = contrib_intensity * opacity_sel * specular_factor

        light_valid = (diffuse_factor > 0.0) & can_reach

        diffuse_contribution = (
            material_color[None, :, :] * light_color_simd * light_factor[..., None]
        )
        spec_contribution = lcolor[:, None, :] * spec_factor[..., None]

        light_color = light_color + torch.sum(
            _where0((light_valid & valid[None, :])[..., None], diffuse_contribution),
            dim=0,
        )
        specular_color = specular_color + torch.sum(
            _where0(
                (light_valid & valid[None, :] & has_specular[None, :])[..., None],
                spec_contribution,
            ),
            dim=0,
        )

    return light_color, specular_color


def ambient(color, valid):
    """Ambient light: colour (1,1,1) value-maximized is itself; intensity
    0.08 (ref raytracer_renderer.rs:752-764)."""
    return _where0(valid[:, None], color) * 0.08


def calculate_lighting(scene: DeviceScene, cfg: RenderConfig, hit: Hit, view_dir,
                       epsilon_distance: float):
    """Direct + specular lighting at a hit wavefront
    (ref raytracer_renderer.rs:731-874) through the `light_shade` kernel,
    ambient added outside it. Returns (direct_rgb incl. ambient,
    specular_rgb)."""
    from .kernels import light_shade

    direct, spec = light_shade(
        scene.light_pack, scene.sph_pack, scene.trb_pack, scene.tri_blk_pack,
        scene.tri_blk_aabb, hit.point.contiguous(), hit.normal.contiguous(),
        view_dir.contiguous(), hit.color.contiguous(), hit.shininess.contiguous(),
        hit.valid.to(torch.float32),
        n_lights=scene.n_lights,
        eps_dist=float(epsilon_distance),
        n_trans_blocks=scene.n_trans_blocks,
        backface_culling=cfg.backface_culling,
        bigtri_trans_rows=scene.bigtri_trans_rows,
    )
    return ambient(hit.color, hit.valid) + direct, spec
