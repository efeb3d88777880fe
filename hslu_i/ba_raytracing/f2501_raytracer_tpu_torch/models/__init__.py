"""Scene "model zoo": the reference's example scenes as builders.

Each module exposes `build_scene(cfg) -> Scene`:
  semesterbild — the flagship benchmark scene (ref src/main.rs)
  test_scene   — spheres/triangles/walls test box (ref examples/test_scene.rs)
  test_text    — OBJ mesh + two lights (ref examples/test_text.rs)
  semesterbild_cloud — semesterbild plus a seeded cloud of small triangles
      past `stream_triangles` (a streamed scene; models/triangle_cloud.py)
"""

from . import semesterbild, test_scene, test_text, triangle_cloud

SCENES = {
    "semesterbild": semesterbild.build_scene,
    "semesterbild_cloud": triangle_cloud.build_scene,
    "test_scene": test_scene.build_scene,
    "test_text": test_text.build_scene,
}


def build(name: str, cfg):
    return SCENES[name](cfg)
