"""Multi-device rendering: a mesh of devices driven by one process (mesh.py)."""

from .mesh import (
    Mesh,
    cast_nearest_objsharded,
    make_mesh,
    mesh_of,
    render_image_sharded,
    shard_scene,
    trace_rays_sharded,
    trace_tiles_sharded,
    trace_tiles_sharded_u32,
    trace_tiles_sharded_u32_gen,
)

__all__ = [
    "Mesh",
    "cast_nearest_objsharded",
    "make_mesh",
    "mesh_of",
    "render_image_sharded",
    "shard_scene",
    "trace_rays_sharded",
    "trace_tiles_sharded",
    "trace_tiles_sharded_u32",
    "trace_tiles_sharded_u32_gen",
]
