"""PyTorch port: the pool loop's chunks as CUDA graphs (ops/trace.py::_run_pool).

On a CUDA device each chunk of `loop_chunk` pool iterations, with its
commit, is captured once per (device, stream) and key, and replayed; on the
CPU the same chunk body runs eagerly. Here, on the CPU: a pool-path frame
captures no graph, records `graph` 0 on every `pool.chunk` span, and keeps
the eager loop's bits (the frames' sha256, as the loop rendered them before
it ran on buffers of its own); the key changes with everything a chunk bakes
in; the launch counts of a capture are added at replay; a swapped kernel
wrapper is seen, handed copies of what a graph rewrites, and its outputs
are refilled. On the card (the `gpu` marker; the `cuda` fixture skips
without one): pool-path frames replay with the CPU twins' image, a swapped
wrapper is called between the graphs at every replay on arguments of its
own, a scene with another light count captures anew,
`shade_eval_rows` counts Σ iters + tiles a replayed frame, the f32 path's
tiles do not share memory, and a two-entry mesh on one card keeps the
one-device bits. This file imports neither JAX nor the JAX test helpers, so
on the card it runs without the repository's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_pool_graph.py
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils import timing

REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)
# the spans' test frame: two tiles of 144 rays, the pool at W = 64
TINY = dict(width=24, height=12, reflections=True, refractions=True, kernel_ray_tile=64,
            compaction_ratio=2, tile_rays=144, device_encode=True, loop_chunk=2)
PACKET = dict(width=16, height=12, reflections=True, refractions=True, device_encode=True,
              anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True,
              packet_mode=True, aa_packet_lanes=8, kernel_ray_tile=64, compaction_ratio=4,
              loop_chunk=8, max_nodes=24)
# (config, sha256 of the u32 frame, dropped, unfinished) of the eager loop
CPU_FRAMES = {
    "rows": (TINY, "d6eba16f268c2584", 0, 0),
    "resort": (dict(TINY, resort_secondary=True), "d6eba16f268c2584", 0, 0),
    "capacity": (dict(TINY, pool_capacity=130), "744c3255165aa6ea", 68, 0),
    "max_nodes": (dict(TINY, max_nodes=3), "e9a394e0a2cb187f", 0, 34),
    "packet": (PACKET, "d19c676571e6169a", 0, 0),
}
# the card's small frames (tests/test_torch_kernels_gpu.py): 64x48, tiles of
# 4096 rays, the pool at W = 512
SMALL = dict(width=64, height=48, scene_backface_culling=True, tile_rays=4096,
             kernel_ray_tile=128, compaction_ratio=8, loop_chunk=16, max_nodes=48,
             weight_cutoff=1e-3, device_encode=True)
CARD_PATHS = {
    "pool": dict(SMALL, **REALISTIC),
    "unpacked": dict(SMALL, packed_stage=False, **REALISTIC),
    "resort": dict(SMALL, resort_secondary=True, **REALISTIC),
    "streamed": dict(SMALL, stream_triangles=1, **REALISTIC),
    "packet": dict(width=40, height=30, scene_backface_culling=True, tile_rays=8192,
                   kernel_ray_tile=64, compaction_ratio=8, loop_chunk=16, max_nodes=48,
                   weight_cutoff=1e-3, device_encode=True, packet_mode=True,
                   aa_packet_lanes=8, anti_aliasing_rotation_scale=True,
                   anti_aliasing_randomness=True, **REALISTIC),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the frames are many small ops, and several test
    workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: pytest -m gpu on the card)")
    trace.drop_pool_graphs()  # each test starts with nothing captured
    return torch.device("cuda")


def _frame(r, scene):
    """(u32 frame, its spans): the frame rendered under a CPU profile, which
    turns the port's spans on."""
    timing.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        px = r.render_u32(scene)
    return px, timing.take_spans()


def _chunks(rec):
    return [s.counters for s in rec if s.name == "pool.chunk"]


def _until_replayed(r, scene):
    """Three frames on a key new to the stream: the first chunk runs eagerly
    and the next is captured (both `graph` 0), every later one is replayed,
    the third frame's all. Returns the three frames and the third's spans."""
    pxs, graphs = [], []
    for _ in range(3):
        px, rec = _frame(r, scene)
        pxs.append(px)
        graphs.append([c["graph"] for c in _chunks(rec)])
    flat = graphs[0] + graphs[1]
    assert flat[:2] == [0, 0] and all(g == 1 for g in flat[2:]), graphs
    assert graphs[2] and all(g == 1 for g in graphs[2]), graphs
    return pxs, rec


def _bytes(t):
    return t.cpu().numpy().tobytes()


def _sha(px):
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()[:16]


def _image_bar(gpu, cpu):
    """The card's frame against the CPU twins' at the image bar of the card
    tests: the same pixels hit, and at most 0.5% of them off by more than
    2e-3 in a channel."""
    assert ((gpu != 0) == (cpu != 0)).mean() > 0.995
    rgb = lambda f: np.stack([(f >> s) & 0xFF for s in (16, 8, 0)], -1) / 255.0  # noqa: E731
    assert (np.abs(rgb(gpu) - rgb(cpu)).max(-1) > 2e-3).mean() < 0.005


@pytest.mark.parametrize("frame", sorted(CPU_FRAMES))
def test_cpu_pool_frame_captures_no_graph_and_keeps_the_eager_bits(frame):
    kw, sha, dropped, unfinished = CPU_FRAMES[frame]
    cfg = RenderConfig(**kw)
    r = RaytracerRenderer(cfg, device="cpu")
    scene = r.device_scene(build("semesterbild", cfg))
    graphs = dict(trace._graphs)
    px, rec = _frame(r, scene)
    assert _sha(px) == sha
    assert (r.last_dropped, r.last_unfinished) == (dropped, unfinished)
    chunks = _chunks(rec)
    assert chunks and all(c["graph"] == 0 for c in chunks)
    assert trace._graphs == graphs  # nothing captured, nothing cached
    assert np.array_equal(r.render_u32(scene), px)


def test_graph_key_names_what_a_chunk_bakes_in(monkeypatch):
    """The key of a chunk graph is hashable and changes with the shapes, the
    config, eps, the commit, the kernels' module settings, the scene's light
    count and the scene tables' storage."""
    cfg = RenderConfig(**TINY)
    scene = RaytracerRenderer(cfg, device="cpu").device_scene(build("semesterbild", cfg))
    shape = (144, 64, 2, 1000, 1000)
    key = trace._graph_key(scene, cfg, 1e-4, *shape)
    assert hash(key) == hash(trace._graph_key(scene, cfg, 1e-4, *shape))
    assert key == trace._graph_key(scene, cfg, 1e-4, *shape)
    soft = RenderConfig(**TINY, soft_shadows=True)
    other = RaytracerRenderer(soft, device="cpu").device_scene(build("semesterbild", soft))
    assert other.n_lights != scene.n_lights
    moved = dataclasses.replace(scene, light_pack=scene.light_pack.clone())
    changed = [
        trace._graph_key(scene, cfg, 1e-4, 288, *shape[1:]),
        trace._graph_key(scene, dataclasses.replace(cfg, weight_cutoff=0.5), 1e-4, *shape),
        trace._graph_key(scene, cfg, 2e-4, *shape),
        trace._graph_key(other, cfg, 1e-4, *shape),
        trace._graph_key(moved, cfg, 1e-4, *shape),
    ]
    monkeypatch.setattr(kernels, "PACKET_MIN_RAYS", 1)
    changed.append(trace._graph_key(scene, cfg, 1e-4, *shape))
    monkeypatch.undo()
    monkeypatch.setattr(trace, "_commit", lambda acc, pix, contrib: None)
    changed.append(trace._graph_key(scene, cfg, 1e-4, *shape))
    assert all(k != key for k in changed)


def test_captured_launches_count_at_replay():
    """Launches inside `counting_into(counts)` go to `counts`, on that thread
    only, and inside a nested `counting_into(None)` to LAUNCHES again;
    `count_launches` adds such a dict to LAUNCHES, once a replay."""
    seen = {}

    def other_thread():
        seen["capturing"] = getattr(kernels._capture, "launches", None)

    with kernels.counting_into({}) as counts:
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and seen["capturing"] is None
        assert kernels._capture.launches is counts
        with kernels.counting_into(None):
            assert kernels._capture.launches is None
        assert kernels._capture.launches is counts
    assert kernels._capture.launches is None and counts == {}
    before = dict(kernels.LAUNCHES)
    try:
        kernels.count_launches({"shade_eval_rows": 3, "cast_triangles": 3})
        kernels.count_launches({"shade_eval_rows": 3, "cast_triangles": 3})
        assert kernels.LAUNCHES["shade_eval_rows"] == before["shade_eval_rows"] + 6
        assert kernels.LAUNCHES["cast_triangles"] == before["cast_triangles"] + 6
        assert kernels.LAUNCHES["light_shade"] == before["light_shade"]
    finally:  # later tests in this process count from where they found it
        kernels.LAUNCHES.update(before)


def test_swapped_wrappers_are_seen_and_a_swapped_eager_chunk_does_not_warm(monkeypatch):
    """`kernels.swapped_wrappers` names a wrapper swapped in and forgets it
    put back; a fresh chunk graph runs its chunks eagerly, and only one run
    with the module's own wrappers warms it."""
    assert kernels.swapped_wrappers() == {}
    own = kernels.shade_eval_rows
    stand_in = lambda *a, **k: own(*a, **k)  # noqa: E731
    ran = []
    g = trace._ChunkGraph()
    monkeypatch.setattr(kernels, "shade_eval_rows", stand_in)
    assert kernels.swapped_wrappers() == {"shade_eval_rows": stand_in}
    for _ in range(3):
        assert g.run(lambda: ran.append(1)) is False
    assert len(ran) == 3 and not g.warm and g.captured is None
    monkeypatch.undo()
    assert kernels.swapped_wrappers() == {}
    assert g.run(lambda: ran.append(1)) is False
    assert len(ran) == 4 and g.warm and g.captured is None


def test_a_swapped_call_gets_copies_and_its_outputs_are_refilled():
    """Between two graphs a swapped wrapper is handed clones of the tensors
    outside the scene's storages (the scene's as they are, host values as
    they are); its outputs, nested in tuples and dicts, are cloned for the
    next graph and refilled at a replay; a host value that differs at a
    replay raises."""
    scene_t, rows = torch.arange(6.0), torch.ones(4)
    got = trace._own_copies([scene_t, rows, 3, None], {scene_t.data_ptr()})
    assert got[0] is scene_t and got[2:] == [3, None]
    assert got[1] is not rows and got[1].data_ptr() != rows.data_ptr()
    assert torch.equal(got[1], rows)
    out = (torch.zeros(2), {"rows": torch.zeros(3), "n": 2})
    held = trace._cloned(out)
    assert held[0].data_ptr() != out[0].data_ptr()
    assert held[1]["rows"].data_ptr() != out[1]["rows"].data_ptr()
    trace._refill(held, (torch.full((2,), 5.0), {"rows": torch.full((3,), 7.0), "n": 2}))
    assert torch.equal(held[0], torch.full((2,), 5.0))
    assert torch.equal(held[1]["rows"], torch.full((3,), 7.0))
    assert torch.equal(out[0], torch.zeros(2))
    with pytest.raises(RuntimeError, match="swapped kernel wrapper"):
        trace._refill(held, (torch.zeros(2), {"rows": torch.zeros(3), "n": 3}))


@pytest.mark.gpu
def test_a_swapped_wrapper_is_called_between_the_graphs_at_every_replay(cuda, monkeypatch):
    """One wrapper swapped in between renders, as a hook that keeps each
    call's arguments: the next chunk is captured, cut at its calls, and
    every later one replayed; the hook sees every node evaluation, one a
    pool iteration and one a tile, and LAUNCHES counts each once; what it
    kept of the first frame's calls still holds what those calls saw after
    two more frames; put back, the chunks capture and replay as one graph
    again. Every frame has the first frame's bits."""
    cfg = RenderConfig(**CARD_PATHS["pool"])
    r = RaytracerRenderer(cfg, device=cuda)
    ds = r.device_scene(build("semesterbild", cfg))
    (px, *_), _ = _until_replayed(r, ds)
    own, calls = kernels.shade_eval_rows, []

    def kept(*a, **k):
        out = own(*a, **k)
        calls.append((a, out, [_bytes(t) for t in a[5:] + out]))
        return out

    monkeypatch.setattr(kernels, "shade_eval_rows", kept)
    graphs, first = [], None
    for _ in range(3):
        calls.clear()
        kernels.reset_launch_counts()
        got, rec = _frame(r, ds)
        chunks = _chunks(rec)
        tiles = sum(s.name == "tile" for s in rec)
        assert np.array_equal(got, px) and chunks
        assert len(calls) == kernels.LAUNCHES["shade_eval_rows"]
        assert len(calls) == sum(c["iters"] for c in chunks) + tiles
        graphs += [c["graph"] for c in chunks]
        first = first or list(calls)
    assert graphs[0] == 0 and all(g == 1 for g in graphs[1:]), graphs
    for a, out, seen in first:
        assert [_bytes(t) for t in a[5:] + out] == seen
    monkeypatch.undo()
    graphs = []
    for _ in range(2):
        got, rec = _frame(r, ds)
        assert np.array_equal(got, px)
        graphs += [c["graph"] for c in _chunks(rec)]
    assert graphs[0] == 0 and graphs[1:] and all(g == 1 for g in graphs[1:]), graphs
    assert all(len(g.captured.graphs) == 1 for g in trace._graphs.values() if g.captured)


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(CARD_PATHS))
def test_pool_frames_replay_with_the_twins_image(cuda, path):
    """A small pool-path frame rendered three times on the card: the first
    chunk runs eagerly, the second is captured, every later one is
    replayed; the frames have one set of bits, and the CPU twins' image at
    the card tests' bar."""
    cfg = RenderConfig(**CARD_PATHS[path])
    scene = build("semesterbild", cfg)
    r = RaytracerRenderer(cfg, device=cuda)
    (first, second, third), _ = _until_replayed(r, r.device_scene(scene))
    assert np.array_equal(first, second) and np.array_equal(first, third)
    assert r.last_dropped == 0 and r.last_unfinished == 0
    twin = RaytracerRenderer(cfg, device="cpu")
    _image_bar(third, twin.render_u32(twin.device_scene(scene)))


@pytest.mark.gpu
def test_another_light_count_captures_anew(cuda):
    """The 5-light scene, then the 50-light soft-shadow scene on the same
    stream, then the first again: each change of scene runs a chunk eagerly
    and captures anew, and each frame has its CPU twin's image and its own
    first frame's bits."""
    frames = {}
    for name in ("hard", "soft", "hard"):
        cfg = RenderConfig(**SMALL, **REALISTIC, soft_shadows=name == "soft")
        scene = build("semesterbild", cfg)
        r = RaytracerRenderer(cfg, device=cuda)
        (px, *again), _ = _until_replayed(r, r.device_scene(scene))
        assert all(np.array_equal(px, a) for a in again)
        twin = RaytracerRenderer(cfg, device="cpu")
        _image_bar(px, twin.render_u32(twin.device_scene(scene)))
        assert frames.setdefault(name, _sha(px)) == _sha(px)
    assert frames["hard"] != frames["soft"]


@pytest.mark.gpu
def test_replayed_frame_counts_every_node_evaluation(cuda):
    """`kernels.LAUNCHES["shade_eval_rows"]` over a replayed frame: one a
    pool iteration (Σ `iters` of its chunks) and one a tile (the primary
    node), as the eager loop counts them. Two tiles of 4096 rays."""
    cfg = RenderConfig(**dict(CARD_PATHS["pool"], width=128, height=64))
    r = RaytracerRenderer(cfg, device=cuda)
    ds = r.device_scene(build("semesterbild", cfg))
    _until_replayed(r, ds)
    kernels.reset_launch_counts()
    _, rec = _frame(r, ds)
    chunks = _chunks(rec)
    tiles = sum(s.name == "tile" for s in rec)
    assert tiles > 1 and all(c["graph"] == 1 for c in chunks)
    assert kernels.LAUNCHES["shade_eval_rows"] == sum(c["iters"] for c in chunks) + tiles
    assert kernels.LAUNCHES["cast_triangles"] == kernels.LAUNCHES["shade_eval_rows"]


@pytest.mark.gpu
def test_f32_tiles_do_not_share_memory(cuda):
    """`trace_rays_tiled` keeps every tile's colours before it stacks them:
    three pool tiles traced together have the bits of each traced alone,
    though all of them went through one graph and one set of buffers."""
    cfg = RenderConfig(**CARD_PATHS["pool"])
    ds = RaytracerRenderer(cfg, device=cuda).device_scene(build("semesterbild", cfg))
    rng = np.random.default_rng(7)
    cam = cfg.camera
    n = cfg.tile_rays
    px, py = rng.integers(0, cfg.width, 3 * n), rng.integers(0, cfg.height, 3 * n)
    o = np.stack([px * cam.w2s_width, py * cam.w2s_height, np.zeros(3 * n)], -1)
    d = o - np.asarray(cam.render_ray_focus)
    o_t, d_t = (torch.from_numpy(a.astype(np.float32).reshape(3, n, 3)).to(cuda) for a in (o, d))
    color, valid = trace.trace_rays_tiled(ds, cfg, o_t, d_t)
    for i in range(3):
        c, v = trace.trace_rays(ds, cfg, o_t[i], d_t[i])
        assert torch.equal(c, color[i]) and torch.equal(v, valid[i]), i
    assert not torch.equal(color[0], color[1])


@pytest.mark.gpu
def test_two_entry_mesh_keeps_the_one_device_bits(cuda):
    """RaytracerRenderer(devices=2) on the card listed twice: each entry
    captures on its own stream, and its frames, the first and the replayed
    ones, have the one-device frame's bits."""
    cfg = RenderConfig(width=128, height=64, tile_rays=2048, kernel_ray_tile=64,
                       compaction_ratio=8, loop_chunk=8, max_nodes=16, device_encode=True,
                       **REALISTIC)
    r1 = RaytracerRenderer(cfg, device=cuda)
    ds = r1.device_scene(build("semesterbild", cfg))
    one = r1.render_u32(ds)
    r2 = RaytracerRenderer(dataclasses.replace(cfg, devices=2), device=["cuda:0"] * 2)
    frames = []
    for _ in range(3):
        px, rec = _frame(r2, ds)
        frames.append(px)
    assert all(np.array_equal(px, one) for px in frames)
    assert _chunks(rec) and all(c["graph"] == 1 for c in _chunks(rec))
    streams = {s for dev, s in trace._graphs if dev == cuda.index or dev == 0}
    assert len(streams) >= 3  # the caller's and one for each entry
