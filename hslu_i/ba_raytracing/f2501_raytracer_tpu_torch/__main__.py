"""CLI entry: render a scene from the model zoo.

The reference has no runtime CLI (all configuration is compile-time cargo
features, SURVEY.md §5); this maps those feature sets onto flags, as the JAX
package's CLI does. `--device` picks the card (the default) or the CPU's
plain PyTorch twins; without a card, `--device cpu` must be given:

  python -m hslu_i.ba_raytracing.f2501_raytracer_tpu_torch \
      --scene semesterbild --preset realistic --width 768 --height 640 \
      --out output.png [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser(**kw) -> argparse.ArgumentParser:
    """The flags the CLI and the examples share."""
    ap = argparse.ArgumentParser(**kw)
    ap.add_argument("--scene", default="semesterbild",
                    choices=["semesterbild", "test_scene", "test_text"])
    ap.add_argument("--preset", default="realistic",
                    choices=["default", "reference_default", "realistic"])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--out", default="./output.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="render on the card (default) or on the CPU")
    return ap


def setup(ap, args, width=None, height=None):
    """(cfg, scene, renderer) for the parsed shared flags; `width` and
    `height` stand in for --width and --height where those are not given.
    Without the device asked for, the parser exits with the device message."""
    from . import RaytracerRenderer, RenderConfig
    from .models import build
    from .utils.devices import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (on the command line: --device cpu)")

    preset = {
        "default": RenderConfig.default_scene,
        "reference_default": RenderConfig.reference_default,
        "realistic": RenderConfig.realistic_scene,
    }[args.preset]
    # reference_default sets scene_backface_culling itself (passing it again,
    # as the JAX package's CLI does, is a duplicate keyword)
    cfg = dataclasses.replace(
        preset(width=args.width or width, height=args.height or height, seed=args.seed),
        scene_backface_culling=True)
    return cfg, build(args.scene, cfg), RaytracerRenderer(cfg, device=device)


def save(buf, out: str) -> None:
    """Print the frame's timing and write it to `out` as a PNG."""
    from .output import FileOutput

    print(f"Render timing done! {buf.timing!r}")
    FileOutput(out).render_buffer(buf)
    print(f"saved {out}")


def main(argv=None):
    ap = build_parser(prog="f2501_raytracer_tpu_torch")
    ap.add_argument("--progress", action="store_true",
                    help="per-tile progressive rendering with status output")
    args = ap.parse_args(argv)
    cfg, scene, renderer = setup(ap, args)
    print(f"Num of obj in scene: {len(scene.scene_objects)}")
    print(cfg.feature_string())

    cb = (lambda b, f: print(f"  {f:6.1%}", end="\r")) if args.progress else None
    save(renderer.render(scene, progress=cb), args.out)


if __name__ == "__main__":
    main()
