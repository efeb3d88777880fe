"""Multi-device rendering over a mesh of torch devices.

The port's counterpart of the JAX package's `parallel/mesh.py`: the same
functions in the same order. The reference's only scale-out axes are SIMD
lanes and rayon threads on one machine (SURVEY.md §2.2/§2.3); the JAX
package maps them onto a `jax.sharding.Mesh` that one controller drives
through `shard_map`. The port keeps the single controller: one process
drives every device of the mesh.

* A mesh is an ordered tuple of `torch.device`s; `devices[0]` is the lead
  device, which holds every joined result. An entry may repeat: one card
  listed k times is k shards, each with a stream of its own. That is how a
  host with one card drives this path; it measures no scaling.
* `rays` axis (data parallel): the scene is replicated once per device
  (`shard_scene`), each entry traces a contiguous share of the rays or of
  the tile axis, and the shares are joined on the lead device: JAX's
  `all_gather` is a `torch.cat` there. Shares may be uneven (JAX's
  `shard_map` needs equal ones); tiles are traced independently, so a
  tile-sharded frame has the one-device frame's bits.
* `objs` axis (tensor parallel over the scene): the triangle blocks are
  split over the entries (`cast_nearest_objsharded`) and the entries'
  nearest hits are combined on the lead device as JAX's two `pmin`s
  combine them.

On CUDA each entry's work runs on a host thread of its own, under its
device and its own stream: the pool loop reads its count on the host once
per chunk (ops/trace.py), so one thread would run the entries one after the
other. The caller's stream waits for every entry's stream before it touches
their results. On the CPU the entries run one after the other.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from ..config import RenderConfig
from ..ops.intersect import BIG_IDX, _homogeneous, _pack_nearest, _sphere_nearest
from ..ops.kernels import cast_triangles_stream
from ..ops.trace import (
    trace_rays,
    trace_rays_tiled,
    trace_rays_tiled_u32,
    trace_rays_tiled_u32_gen,
)
from ..scene.device import ARRAY_FIELDS, DeviceScene
from ..utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along one named axis, in order; `devices[0]` is the lead."""

    devices: tuple
    axis_names: tuple = ("rays",)
    # one CUDA stream per entry, made on first use: entries on one card
    # need streams of their own to overlap
    _streams: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def stream(self, i: int) -> torch.cuda.Stream:
        if i not in self._streams:
            self._streams[i] = torch.cuda.Stream(device=self.devices[i])
        return self._streams[i]


def _entry(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise RuntimeError(f"no device {dev}: this host has "
                               f"{torch.cuda.device_count()} CUDA devices")
        dev = torch.device("cuda", idx)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "rays",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the host's cards cuda:0 ... cuda:n-1 (all of them when
    `n_devices` is None); raises RuntimeError when the host has fewer than
    asked. `devices` lists the entries instead, repeats allowed: ["cpu"] * 8
    runs the plain twins on the CPU, as the tests do; ["cuda:0"] * k splits
    one card k ways."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else int(n_devices)
        if not 1 <= n <= have:
            raise RuntimeError(f"a mesh of {n} CUDA devices: this host has {have}")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(_entry(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"{len(devs)} devices listed for a mesh of {n_devices}")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh is all CUDA or all CPU, got {devs}")
    return Mesh(devs, (axis,))


def mesh_of(n_devices: int, device=None, axis: str = "rays") -> Mesh:
    """The mesh of `n_devices` entries that an entry point's `device`
    argument names: the devices of a list, n CPU entries for "cpu", else
    the host's cards (`make_mesh`: none other than those)."""
    if isinstance(device, (list, tuple)):
        return make_mesh(n_devices, axis, devices=device)
    if device is not None and torch.device(device).type == "cpu":
        return make_mesh(axis=axis, devices=["cpu"] * n_devices)
    return make_mesh(n_devices, axis)


def shard_scene(scene: DeviceScene, mesh: Mesh) -> tuple:
    """The scene on every entry of the mesh: one DeviceScene per entry.
    Entries on one device share one copy (the scene itself on the device
    it already lies on)."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = dataclasses.replace(
                scene, **{f: getattr(scene, f).to(dev) for f in ARRAY_FIELDS})
    return tuple(copies[dev] for dev in mesh.devices)


def _replicas(scene, mesh: Mesh) -> tuple:
    """A DeviceScene's replicas, or the replicas `shard_scene` made before
    (the renderer makes them once per frame)."""
    if isinstance(scene, DeviceScene):
        return shard_scene(scene, mesh)
    if len(scene) != len(mesh):
        raise ValueError(f"{len(scene)} scene replicas for a mesh of {len(mesh)}")
    return tuple(scene)


def _shares(n: int, k: int) -> list:
    """Contiguous [start, stop) runs of n items over k entries, the first
    n % k of them one longer."""
    q, r = divmod(n, k)
    bounds = [0]
    for i in range(k):
        bounds.append(bounds[-1] + q + (i < r))
    return list(zip(bounds[:-1], bounds[1:]))


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _on_entries(mesh: Mesh, fn, args: list, gather: bool = True) -> list:
    """[fn(i, *args[i])] for each entry i that has work (args[i] not None),
    in entry order, the tensors of args[i] moved to entry i's device first.
    The results are on the lead device (`gather`) or on their entries'
    devices. On CUDA each entry runs on a host thread of its own, under its
    device and stream; an exception on any entry is raised here."""
    if mesh.lead.type == "cpu":
        return [fn(i, *a) for i, a in enumerate(args) if a is not None]
    lead = mesh.lead
    caller = torch.cuda.current_stream(lead)  # where the inputs were made

    def job(i):
        dev, s = mesh.devices[i], mesh.stream(i)
        with torch.cuda.device(dev), torch.cuda.stream(s):
            s.wait_stream(caller)
            # cross-device copies synchronise the current streams of both
            # devices: the caller's on the lead, this entry's on `dev`
            with torch.cuda.stream(caller):
                a = _to(args[i], dev)
            out = fn(i, *a)
            if gather:
                with torch.cuda.stream(caller):
                    out = _to(out, lead)
            return out

    todo = [i for i, a in enumerate(args) if a is not None]
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        futures = [(i, pool.submit(job, i)) for i in todo]
        results = {i: f.result() for i, f in futures}
    for i in todo:
        for t in _tensors(results[i]):
            # this thread's stream on the result's device waits for the
            # entry's, and the allocator keeps the entry's memory until it
            # has read it
            use = torch.cuda.current_stream(t.device)
            use.wait_stream(mesh.stream(i))
            t.record_stream(use)
    return [results[i] for i in todo]


def render_image_sharded(scene: DeviceScene, cfg: RenderConfig, origins, directions,
                         mesh: Mesh):
    """One multi-device render step: the rays split into `len(mesh)`
    contiguous shares, each traced on its entry against the scene's
    replica, the shares joined on the lead device (JAX's tiled
    `all_gather`). Returns (color (R, 3), valid (R,)).

    On the stack and lighting-only paths each ray is traced alone, so the
    result has `trace_rays`' bits. A share takes the pool path by its own
    width, and the pool's service order, with it the order of a pixel's
    f32 sums, follows the width: there the colours agree with `trace_rays`
    to rounding, not to the bit (`valid` is the same)."""
    color, valid = zip(*_trace_shares(scene, cfg, origins, directions, mesh, gather=True))
    return torch.cat(color), torch.cat(valid)


def trace_tiles_sharded(scene, cfg: RenderConfig, o_tiles, d_tiles, mesh: Mesh,
                        with_stats: bool = False):
    """`trace_rays_tiled` with the tile axis split over the mesh: each entry
    traces its contiguous run of the (n_tiles, T, 3) tiles against the
    scene's replica (a DeviceScene, or its `shard_scene` replicas). Returns
    (color (n_tiles, T, 3), valid (n_tiles, T)) on the lead device, the
    one-device call's bits; `with_stats` adds {"dropped", "unfinished": each
    count summed}."""
    reps = _replicas(scene, mesh)

    def entry(i, o, d):
        c, v, st = trace_rays_tiled(reps[i], cfg, o, d, with_stats=True)
        return c, v, st["dropped"], st["unfinished"]

    outs = _on_entries(mesh, entry, [(o_tiles[a:b], d_tiles[a:b]) if b > a else None
                                     for a, b in _shares(o_tiles.shape[0], len(mesh))])
    color = torch.cat([out[0] for out in outs])
    valid = torch.cat([out[1] for out in outs])
    if with_stats:
        return color, valid, {k: torch.stack([out[j] for out in outs]).sum()
                              for j, k in ((2, "dropped"), (3, "unfinished"))}
    return color, valid


def _join(outs) -> tuple:
    """The entries' (u32, counts...) joined along the tile axis."""
    return tuple(torch.cat(parts) for parts in zip(*outs))


def trace_tiles_sharded_u32(scene, cfg: RenderConfig, o_tiles, d_tiles, aa_weights,
                            mesh: Mesh, with_stats: bool = False):
    """`trace_rays_tiled_u32` with the tile axis split over the mesh (the
    AA reduction and pixel encode on each entry). Returns (u32 (n_tiles, P)
    as int64, dropped (n_tiles,)) on the lead device, with `with_stats` also
    unfinished (n_tiles,)."""
    reps = _replicas(scene, mesh)
    return _join(_on_entries(
        mesh, lambda i, o, d, w: trace_rays_tiled_u32(reps[i], cfg, o, d, w, with_stats),
        [(o_tiles[a:b], d_tiles[a:b], aa_weights) if b > a else None
         for a, b in _shares(o_tiles.shape[0], len(mesh))]))


def trace_tiles_sharded_u32_gen(scene, cfg: RenderConfig, order_group, offsets, aa_weights,
                                mesh: Mesh, n_tiles: int, with_stats: bool = False):
    """`trace_rays_tiled_u32_gen` with the tile axis split over the mesh:
    each entry generates its tiles' rays from its run of the tile-major
    pixel permutation `order_group` (n_tiles * P,), traces them and encodes
    the pixels. Returns (u32 (n_tiles, P) as int64, dropped (n_tiles,)) on
    the lead device, the one-device call's bits; with `with_stats` also
    unfinished (n_tiles,)."""
    reps = _replicas(scene, mesh)
    P = order_group.shape[0] // n_tiles
    return _join(_on_entries(
        mesh, lambda i, og, offs, w, n: trace_rays_tiled_u32_gen(reps[i], cfg, og, offs, w,
                                                                 n_tiles=n, with_stats=with_stats),
        [(order_group[a * P:b * P], offsets, aa_weights, b - a) if b > a else None
         for a, b in _shares(n_tiles, len(mesh))]))


def trace_rays_sharded(scene, cfg: RenderConfig, origins, directions, mesh: Mesh) -> list:
    """Data-parallel trace with the outputs left in shards: a list of
    (color, valid), one per entry with rays, each on its entry's device."""
    return _trace_shares(scene, cfg, origins, directions, mesh, gather=False)


def _trace_shares(scene, cfg, origins, directions, mesh, gather):
    reps = _replicas(scene, mesh)
    return _on_entries(
        mesh, lambda i, o, d: trace_rays(reps[i], cfg, o, d),
        [(origins[a:b], directions[a:b]) if b > a else None
         for a, b in _shares(origins.shape[0], len(mesh))], gather=gather)


def cast_nearest_objsharded(scene: DeviceScene, o, d, mesh: Mesh,
                            backface_culling: bool = False):
    """Tensor-parallel nearest-hit cast: the Morton blocks split into
    `len(mesh)` contiguous runs, rays and the rest of the scene replicated.
    Each entry takes the spheres and the big-primitive pack in plain
    PyTorch (small; JAX computes them replicated too) and its run of blocks
    through `cast_triangles_stream` (one superblock per block: exact, the
    box gate never changes a result). The entries' hits are combined on the
    lead device as JAX's two `pmin`s do: the least t, then the least object
    index among the entries that have it (an earlier block wins a tie, as in
    the dense cast). Returns (t (R,), obj_idx (R,) int64, valid (R,)) on the
    lead device."""
    nb, B, S = scene.triangle_blocks, scene.tri_block, scene.sphere_slots
    k = len(mesh)
    if nb % k:
        raise ValueError(f"triangle blocks ({nb}) must divide the mesh ({k})")
    local = nb // k
    reps = _replicas(scene, mesh)

    def entry(i, o, d):
        sc = reps[i]
        best_t, best_idx = _sphere_nearest(sc, o, d, backface_culling)
        bt, bidx = _pack_nearest(sc.trb_pack, _homogeneous(o), d, backface_culling)
        closer = bt < best_t
        best_t = torch.where(closer, bt, best_t)
        best_idx = torch.where(closer, S + bidx, best_idx)
        run = slice(i * local, (i + 1) * local)
        aabb = sc.tri_aabb[run]
        tt, tidx = cast_triangles_stream(sc.tri_cast_pack[run], aabb, aabb, o, d,
                                         sb_sizes=(1,) * local,
                                         backface_culling=backface_culling)
        closer = tt < best_t
        best_t = torch.where(closer, tt, best_t)
        base = S + sc.n_bigtris + B * i * local  # local slot b*B + c -> global
        return best_t, torch.where(closer, base + tidx.long(), best_idx)

    outs = _on_entries(mesh, entry, [(o, d)] * k)
    t_all = torch.stack([t for t, _ in outs])
    idx_all = torch.stack([i for _, i in outs])
    t = t_all.amin(0)
    idx = torch.where(t_all == t, idx_all, BIG_IDX).amin(0)
    return t, idx, torch.isfinite(t)
