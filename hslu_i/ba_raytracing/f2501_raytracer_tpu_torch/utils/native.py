"""ctypes bindings to the native host runtime (csrc/rt_host.cpp).

The reference's host pipeline is 100% native Rust; here the host-side
runtime (OBJ parsing, geometry precompute, Morton clustering, PNG encode) is
native C++, built on demand with g++ and loaded via ctypes. Every entry
point has a pure-python fallback so the framework still works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
)
_SRC = os.path.join(_ROOT, "csrc", "rt_host.cpp")
_BUILD_DIR = os.path.join(_ROOT, "csrc", "build")


def _so_path() -> Optional[str]:
    """Build artifact keyed on the SOURCE CONTENT hash (not mtime): a stale
    binary can never shadow an edited rt_host.cpp, and a fresh clone (where
    checkout equalizes mtimes) rebuilds exactly when the source changed.
    Binaries are machine-local (-march=native) and gitignored."""
    if not os.path.exists(_SRC):
        return None
    import hashlib

    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"librt_host-{digest}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent builders race safely
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("RT_DISABLE_NATIVE") == "1":
            return None
        so = _so_path()
        if so is None:
            return None
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        i64, f32p, f64p = ctypes.c_int64, np.ctypeslib.ndpointer(np.float32), np.ctypeslib.ndpointer(np.float64)
        i32p = np.ctypeslib.ndpointer(np.int32)
        u8p = np.ctypeslib.ndpointer(np.uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.rt_woop_transforms.argtypes = [f64p, f64p, f64p, i64, f32p, f32p, u8p]
        lib.rt_obj_open.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i64p, i64p]
        lib.rt_obj_fill.argtypes = [f32p, f32p, i32p, i32p, i32p, ctypes.c_char_p]
        lib.rt_obj_mat_name.argtypes = [i64, ctypes.c_char_p, i64]
        lib.rt_morton_order.argtypes = [f32p, i64, i32p]
        lib.rt_cluster_aabbs.argtypes = [f32p, i64, i64, f32p]
        lib.rt_png_encode.argtypes = [u8p, i64, i64]
        lib.rt_png_encode.restype = ctypes.c_int64
        lib.rt_png_copy.argtypes = [u8p]
        _lib = lib
        return _lib


def native_woop_transforms(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    n = v1.shape[0]
    w4 = np.zeros((n, 4, 3), np.float32)
    nsq = np.zeros((n,), np.float32)
    ok = np.zeros((n,), np.uint8)
    lib.rt_woop_transforms(
        np.ascontiguousarray(v1, np.float64),
        np.ascontiguousarray(v2, np.float64),
        np.ascontiguousarray(v3, np.float64),
        n,
        w4,
        nsq,
        ok,
    )
    return w4, nsq, ok.astype(bool)


def native_parse_obj(path: str):
    """Returns (positions (V,3), normals (N,3), tri_pos (T,3), tri_nrm (T,3),
    tri_mat (T,), mat_names list, mtllib str) or None."""
    lib = get_lib()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    nn = ctypes.c_int64()
    nt = ctypes.c_int64()
    nmat = ctypes.c_int64()
    ml = ctypes.c_int64()
    rc = lib.rt_obj_open(
        os.fspath(path).encode(),
        ctypes.byref(nv),
        ctypes.byref(nn),
        ctypes.byref(nt),
        ctypes.byref(nmat),
        ctypes.byref(ml),
    )
    if rc != 0:
        return None
    positions = np.zeros((nv.value, 3), np.float32)
    normals = np.zeros((nn.value, 3), np.float32)
    tri_pos = np.zeros((nt.value, 3), np.int32)
    tri_nrm = np.zeros((nt.value, 3), np.int32)
    tri_mat = np.zeros((nt.value,), np.int32)
    mtllib = ctypes.create_string_buffer(ml.value + 1)
    lib.rt_obj_fill(positions, normals, tri_pos, tri_nrm, tri_mat, mtllib)
    names = []
    buf = ctypes.create_string_buffer(1024)
    for i in range(nmat.value):
        lib.rt_obj_mat_name(i, buf, 1024)
        names.append(buf.value.decode(errors="replace"))
    lib.rt_obj_close()
    return positions, normals, tri_pos, tri_nrm, tri_mat, names, mtllib.value.decode(errors="replace")


def native_morton_order(centroids: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    n = centroids.shape[0]
    order = np.zeros((n,), np.int32)
    lib.rt_morton_order(np.ascontiguousarray(centroids, np.float32), n, order)
    return order


def native_cluster_aabbs(verts: np.ndarray, cluster_size: int) -> Optional[np.ndarray]:
    """verts (T, 3, 3) ordered triangle vertices -> (ceil(T/cs), 6) AABBs."""
    lib = get_lib()
    if lib is None:
        return None
    n = verts.shape[0]
    nc = (n + cluster_size - 1) // cluster_size
    aabbs = np.zeros((nc, 6), np.float32)
    lib.rt_cluster_aabbs(
        np.ascontiguousarray(verts, np.float32).reshape(-1), n, cluster_size, aabbs
    )
    return aabbs


def native_png_encode(rgb: np.ndarray) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    h, w, _ = rgb.shape
    size = lib.rt_png_encode(np.ascontiguousarray(rgb, np.uint8), w, h)
    if size < 0:
        return None
    out = np.zeros((size,), np.uint8)
    lib.rt_png_copy(out)
    return out.tobytes()
