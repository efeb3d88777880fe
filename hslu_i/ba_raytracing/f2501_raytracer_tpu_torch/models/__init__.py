"""Scene "model zoo": the reference's example scenes as builders.

Each module exposes `build_scene(cfg) -> Scene`. The port carries the
flagship scene only so far (ROADMAP.md, Queue 1 item 9 lists the others):
  semesterbild — the flagship benchmark scene (ref src/main.rs)
"""

from . import semesterbild

SCENES = {
    "semesterbild": semesterbild.build_scene,
}


def build(name: str, cfg):
    return SCENES[name](cfg)
