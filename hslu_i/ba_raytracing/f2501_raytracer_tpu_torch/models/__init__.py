"""Scene "model zoo": the reference's example scenes as builders.

Each module exposes `build_scene(cfg) -> Scene`. The port carries the
flagship scene only so far (ROADMAP.md, Queue 1 item 9 lists the others):
  semesterbild — the flagship benchmark scene (ref src/main.rs)
  semesterbild_cloud — semesterbild plus a seeded cloud of small triangles
      past `stream_triangles` (a streamed scene; models/triangle_cloud.py)
"""

from . import semesterbild, triangle_cloud

SCENES = {
    "semesterbild": semesterbild.build_scene,
    "semesterbild_cloud": triangle_cloud.build_scene,
}


def build(name: str, cfg):
    return SCENES[name](cfg)
