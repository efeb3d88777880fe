"""OBJ/MTL mesh loader.

Reimplements the subset of `tobj` the reference relies on
(ref scene/scene.rs:43-134: triangulate + single_index load, per-mesh
material, Kd/illum/Pm/Ps material mapping). Parsing runs through the native
C++ host runtime (csrc/rt_host.cpp) when available, with a pure-python
fallback; both produce the same index arrays.

Faces are fan-triangulated; per-face normals are merged from the vertex
normals by the reference's asymmetric lerp chain n1.lerp(n2,0.5).lerp(n3,0.5)
(scene.rs:102-111) and NOT re-normalized.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..materials import Material, material_from_mtl
from ..utils.native import native_parse_obj
from .builder import Scene, Similarity3, TriangleData


def parse_mtl(path: str) -> Dict[str, dict]:
    """Parse a .mtl file into {name: {Kd, illum, Pm, Ps, ...}}."""
    materials: Dict[str, dict] = {}
    current: Optional[dict] = None
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                current = {}
                materials[" ".join(parts[1:])] = current
            elif current is None:
                continue
            elif key == "Kd":
                current["Kd"] = tuple(float(x) for x in parts[1:4])
            elif key == "illum":
                current["illum"] = int(float(parts[1]))
            else:
                # unknown params (incl. Pm / Ps) kept verbatim like tobj
                current[key] = parts[1] if len(parts) == 2 else parts[1:]
    return materials


def _parse_obj_python(path: str):
    """Fallback parser: same output contract as native_parse_obj."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    tri_pos: List[Tuple[int, int, int]] = []
    tri_nrm: List[Tuple[int, int, int]] = []
    tri_mat: List[int] = []
    names: List[str] = []
    name_ids: Dict[str, int] = {}
    mtllib = ""
    cur = -1

    def resolve(idx: int, count: int) -> int:
        return idx - 1 if idx > 0 else count + idx

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "mtllib":
                mtllib = " ".join(parts[1:])
            elif key == "usemtl":
                nm = " ".join(parts[1:])
                if nm not in name_ids:
                    name_ids[nm] = len(names)
                    names.append(nm)
                cur = name_ids[nm]
            elif key == "f":
                verts = []
                for spec in parts[1:]:
                    comps = spec.split("/")
                    vi = resolve(int(comps[0]), len(positions))
                    ni = -1
                    if len(comps) >= 3 and comps[2] != "":
                        ni = resolve(int(comps[2]), len(normals))
                    verts.append((vi, ni))
                for k in range(1, len(verts) - 1):
                    tri_pos.append((verts[0][0], verts[k][0], verts[k + 1][0]))
                    tri_nrm.append((verts[0][1], verts[k][1], verts[k + 1][1]))
                    tri_mat.append(cur)

    return (
        np.asarray(positions, np.float32).reshape(-1, 3),
        np.asarray(normals, np.float32).reshape(-1, 3),
        np.asarray(tri_pos, np.int32).reshape(-1, 3),
        np.asarray(tri_nrm, np.int32).reshape(-1, 3),
        np.asarray(tri_mat, np.int32),
        names,
        mtllib,
    )


def load_obj_scene(
    path,
    transform: Optional[Similarity3] = None,
    continue_on_material_failure: bool = True,
) -> Scene:
    """ref scene/scene.rs:43-134."""
    path = os.fspath(path)
    parsed = native_parse_obj(path)
    if parsed is None:
        parsed = _parse_obj_python(path)
    positions, normals, tri_pos, tri_nrm, tri_mat, names, mtllib = parsed

    materials: Dict[int, Material] = {}
    if mtllib:
        mtl_path = os.path.join(os.path.dirname(path), mtllib)
        try:
            by_name = {n: material_from_mtl(m) for n, m in parse_mtl(mtl_path).items()}
            materials = {i: by_name[n] for i, n in enumerate(names) if n in by_name}
        except OSError:
            if not continue_on_material_failure:
                raise

    if transform is not None:
        from .builder import quat_rotate_batch

        if len(positions):
            positions = quat_rotate_batch(
                transform.rotation, positions * np.float32(transform.scale)
            ) + np.asarray(transform.translation, np.float32)
        if len(normals):
            normals = quat_rotate_batch(transform.rotation, normals)

    default_mat = Material.diffuse((1.0, 1.0, 1.0))
    scene = Scene()
    for i in range(tri_pos.shape[0]):
        vi = tri_pos[i]
        ps = [positions[vi[0]], positions[vi[1]], positions[vi[2]]]
        ns = [normals[j] if j >= 0 else None for j in tri_nrm[i]]
        have = [n for n in ns if n is not None]
        # normal merge, ref scene.rs:102-111
        if len(have) == 0:
            normal = None
        elif len(have) == 1:
            normal = have[0]
        elif len(have) == 2:
            normal = have[0] + (have[1] - have[0]) * 0.5
        else:
            mid = have[0] + (have[1] - have[0]) * 0.5
            normal = mid + (have[2] - mid) * 0.5
        material = materials.get(int(tri_mat[i]), default_mat)
        if normal is not None:
            scene.add_triangle(
                TriangleData.with_material_and_normal(ps[0], ps[1], ps[2], normal, material)
            )
        else:
            scene.add_triangle(TriangleData.with_material(ps[0], ps[1], ps[2], material))
    return scene
