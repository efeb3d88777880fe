"""The port's entry points in the style of the repository's
`__graft_entry__.py`: one render step and its inputs (`entry`), and a
multi-device dry run (`dryrun_multichip`).

    python -m hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.graft_entry

runs `entry()`'s step once on the card, then `dryrun_multichip` over every
card of the host (at most 8).
"""

from __future__ import annotations

import numpy as np
import torch

from . import RenderConfig, build_device_scene
from .models import build
from .ops.camera import pixel_scene_coords
from .ops.trace import trace_rays
from .ops.vecmath import normalized
from .parallel import (
    cast_nearest_objsharded,
    make_mesh,
    mesh_of,
    render_image_sharded,
    trace_tiles_sharded_u32_gen,
)
from .renderer import frame_order_device, plan_frame
from .scene.builder import Scene
from .utils.devices import resolve_device


def _flagship(cfg_kw=None, device=None):
    """(cfg, DeviceScene, origins, directions) of a small semesterbild
    frame's primary rays on `device` (default: the card)."""
    kw = dict(width=64, height=32, reflections=True, refractions=True,
              scene_backface_culling=True, max_nodes=24, stack_size=24)
    kw.update(cfg_kw or {})
    min_tri_blocks = kw.pop("min_tri_blocks", 1)
    cfg = RenderConfig(**kw)
    dev = resolve_device(device)
    scene = build("semesterbild", cfg)
    if cfg.scene_backface_culling:
        scene = Scene.backface_culling(scene, np.array([0.0, 0.0, 1.0]))
    dscene = build_device_scene(scene, cfg, min_tri_blocks=min_tri_blocks, device=dev)
    px, py = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))
    coords = pixel_scene_coords(cfg, px.reshape(-1), py.reshape(-1))
    dirs = coords - np.asarray(cfg.camera.render_ray_focus, np.float32)
    return (cfg, dscene, torch.from_numpy(np.ascontiguousarray(coords, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(dirs, np.float32)).to(dev))


def entry(device=None):
    """(fn, example_args): one forward render step on the flagship
    semesterbild scene (primary cast and the full Whitted wavefront) and
    its inputs, on `device` (default: the card)."""
    cfg, dscene, o, d = _flagship(device=device)

    def render_step(scene, origins, directions):
        return trace_rays(scene, cfg, origins, directions)

    return render_step, (dscene, o, d)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One small step of each multi-device path over a mesh of `n_devices`
    entries: a rays-axis render (`render_image_sharded`), an objs-axis cast
    (`cast_nearest_objsharded`) and the u32 mesh pipeline the renderer runs
    per launch group (device ray generation, pixel encode, drop counter;
    `trace_tiles_sharded_u32_gen`). The mesh is the host's cards (default;
    raises when it has fewer), `n_devices` CPU entries (`device="cpu"`), or
    a list of `n_devices` devices. Asserts non-empty results and no
    dropped rays (RuntimeError otherwise)."""
    mesh = mesh_of(n_devices, device)
    # tiles of one 32-pixel row: a tile for every entry
    cfg, dscene, o, d = _flagship(dict(width=32, height=n_devices, tile_rays=32, max_nodes=8,
                                       min_tri_blocks=n_devices), mesh.lead)

    color, valid = render_image_sharded(dscene, cfg, o, d, mesh)
    _check(color.shape == (o.shape[0], 3) and color.device == mesh.lead,
           f"multichip render gave {tuple(color.shape)} on {color.device}")
    _check(bool(valid.any()), "multichip render produced an empty frame")

    obj_mesh = make_mesh(devices=mesh.devices, axis="objs")
    t, idx, hitv = cast_nearest_objsharded(dscene, o, normalized(d), obj_mesh)
    _check(bool(hitv.any()), "object-sharded cast found no hits")

    plan = plan_frame(cfg)
    order_dev, offs_dev = frame_order_device(cfg, plan, plan.n_tiles, mesh.lead)
    w = torch.from_numpy(plan.weights).to(mesh.lead)
    u32, dropped = trace_tiles_sharded_u32_gen(dscene, cfg, order_dev, offs_dev, w, mesh,
                                               n_tiles=plan.n_tiles)
    n_px = int((u32 != 0).sum())
    _check(n_px > 0, "mesh wall pipeline produced an empty frame")
    _check(int(dropped.sum()) == 0, "mesh wall pipeline dropped rays")
    print(f"dryrun_multichip({n_devices}) on {', '.join(map(str, mesh.devices))}: "
          f"rays-sharded render ok ({int(valid.sum())} hits), obj-sharded cast ok "
          f"({int(hitv.sum())} hits), wall pipeline (device raygen + u32 encode) ok "
          f"({n_px} px)")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(x.shape) for x in out])
    dryrun_multichip(min(8, torch.cuda.device_count()))
