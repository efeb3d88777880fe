"""Render the flagship semesterbild scene (ref src/main.rs) and save a PNG,
on the card (`--device cpu`: the plain PyTorch twins on the CPU).

Usage: python -m hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.examples.semesterbild
       [--width W] [--height H] [--out PATH] [--small]
       [--preset default|reference_default|realistic]
       [--scene semesterbild|test_scene|test_text] [--live | --serve]
       [--seed N] [--device cuda|cpu]
(or run this file). The flags are those of the JAX package's
examples/semesterbild.py, plus the port CLI's --seed and --device
(`__main__.py`, whose parser and set-up it shares).
"""

from __future__ import annotations

import os
import sys

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4)))

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.__main__ import (  # noqa: E402
    build_parser,
    save,
    setup,
)


def main(argv=None):
    ap = build_parser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="228x190 quick render")
    ap.add_argument("--live", action="store_true",
                    help="terminal live preview of the progressive render "
                         "(the reference's window analog; also rewrites "
                         "OUT.partial.png as tiles land)")
    ap.add_argument("--serve", action="store_true",
                    help="interactive live view over HTTP: open the printed "
                         "URL in a browser for a fit-screen window that "
                         "refreshes as tiles land; Escape stops the render")
    args = ap.parse_args(argv)
    small = (228, 190) if args.small else (None, None)
    cfg, scene, renderer = setup(ap, args, *small)
    print(f"{args.scene}: {len(scene.scene_objects)} objects, "
          f"{len(scene.scene_lights)} lights | {cfg.feature_string()}")

    if args.serve:
        from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output.http_preview import (
            HttpPreview,
            RenderAborted,
        )

        preview = HttpPreview(title=cfg.feature_string())
        url = preview.start()
        print(f"live view: {url}  (Escape in the page stops the render)")
        try:
            buf = renderer.render(scene, progress=preview)
        except RenderAborted:
            print("\nrender stopped from the live view")
            return
        preview.finish(buf)
    elif args.live:
        from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output.preview import (
            TerminalPreview,
        )

        preview = TerminalPreview(png_path=args.out + ".partial.png")
        buf = renderer.render(scene, progress=preview)
        preview.finish(buf)
    else:
        buf = renderer.render(scene, progress=lambda b, f: print(f"  {f:6.1%}", end="\r"))
    print()
    save(buf, args.out)


if __name__ == "__main__":
    main()
