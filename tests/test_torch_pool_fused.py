"""PyTorch port: the pool iteration as five kernels (ops/trace.py::_pool_loop,
`fused_step`): `pool_take`, `cast_triangles`, `pool_hit`, `shade_eval_rows`,
`pool_put` (ops/kernels.py).

On the CPU the three glue wrappers take their plain twins. Here they are
held bit for bit against the PyTorch glue the pool loop ran before them,
copied below as `_glue_iteration`: one iteration from a drained pool, a
pool below W, a deep pool and a full one where the capacity cap engages and
`dropped` grows, with reflections and refractions (k = 2) and with each
alone (k = 1), back-face culling on and off; and whole tiles of the pool
path, the fused iterations against the glue's, to the same colours and
counts. On the card (the `gpu` marker; the `cuda` fixture skips without
one): each kernel against its twin bit for bit on the pools of the 1080p
`realistic` frame (W = 2048) and of the 480x270 `extreme` frame (W = 3584),
drained iterations included; the frames' checksums, and one `pool_put`
launch per pool iteration. This file imports neither JAX nor the JAX test
helpers, so on the card it runs without the repository's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_pool_fused.py
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (
    RaytracerRenderer,
    RenderConfig,
    build_device_scene,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.intersect import (
    INF,
    _backface_mask,
    _sphere_cos,
    _sphere_ts,
    _where0,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops.vecmath import normalized
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.utils.harness import same_bits, tile_call

# the CPU frames: tiles of 144 rays, the pool at W = 64
TINY = dict(width=24, height=12, kernel_ray_tile=64, compaction_ratio=2, tile_rays=144,
            loop_chunk=2, device_encode=True)
CHILDREN = {"both": dict(reflections=True, refractions=True),
            "refl": dict(reflections=True, refractions=False),
            "refr": dict(reflections=False, refractions=True)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: many small ops, and several test workers share
    the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _glue_iteration(scene, cfg, eps, pool, count, dropped, stage_pix, stage_contrib, slot,
                    R, W, Q_cap):
    """One pool iteration as the pool loop ran it in PyTorch ops before the
    fused path (its take, `cast_rays` with the spheres and the epilogue, the
    active lanes' hits, the node's arguments, the node, the staging, the cap
    and the append), written out op for op. Returns (count, dropped) and
    updates pool and the staging rows in place."""
    lanes = torch.arange(W, dtype=torch.int64)
    start = torch.clamp(count - W, min=0)
    idx = start + lanes
    sel_active = idx < count
    rows = pool.index_select(0, idx)
    o, d, w = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    ior, budget = rows[:, 9], rows[:, 10].to(torch.int32)
    from_refl, pix = rows[:, 11] != 0.0, rows[:, 12].to(torch.int64)
    # the park and the cast
    o = torch.where(sel_active[:, None], o, torch.full_like(o, 1e9))
    zdir = torch.zeros_like(d)
    zdir[:, 2] = 1.0
    d = torch.where(sel_active[:, None], d, zdir)
    S = scene.sphere_slots
    st, s_valid = _sphere_ts(scene.sph_center, scene.sph_r_sq, scene.sph_valid, o, d)
    if cfg.backface_culling:
        cos = _sphere_cos(scene.sph_center, o, d, _where0(s_valid, st))
        s_valid = s_valid & _backface_mask(cos, scene.mat_has_trans[None, :S])
    st = torch.where(s_valid, st, torch.full_like(st, INF))
    best_t, best_idx = torch.min(st, dim=1).values, torch.argmin(st, dim=1)
    tt, tidx = kernels.cast_triangles(
        scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb, o, d,
        backface_culling=cfg.backface_culling, sb_sizes=scene.sb_sizes)
    closer = tt < best_t
    best_t = torch.where(closer, tt, best_t)
    best_idx = torch.where(closer, S + tidx.long(), best_idx)
    valid = torch.isfinite(best_t)
    point = o + d * _where0(valid, best_t)[:, None]
    row = scene.mat_pack.index_select(0, best_idx)
    aux = row[:, 9:12]
    normal = torch.where((best_idx < S)[:, None], normalized(point - aux), aux)
    hval = valid & sel_active
    point = torch.where(hval[:, None], point, torch.full_like(point, 1e9))
    # the node
    f32 = torch.float32
    contrib, rfl_rows, rfl_m, rfr_rows, rfr_m = kernels.shade_eval_rows(
        scene.light_pack, scene.sph_pack, scene.trb_pack, scene.tri_blk_pack,
        scene.tri_blk_aabb, point, normal.contiguous(), d.contiguous(),
        row[:, 0:3].contiguous(), row[:, 4].contiguous(), hval.to(f32),
        best_t.contiguous(), w.contiguous(), ior.contiguous(), budget.contiguous(),
        from_refl.to(f32), (row[:, 7] != 0.0).to(f32), row[:, 3].contiguous(),
        row[:, 5].contiguous(), row[:, 6].contiguous(), row[:, 8].contiguous(),
        pix.to(torch.int32), **trace._node_kw(scene, cfg, eps))
    cand = ([(rfr_rows, rfr_m)] if cfg.refractions else []) + (
        [(rfl_rows, rfl_m)] if cfg.reflections else [])
    rows_b = torch.cat([r for r, _ in cand], dim=0)
    masks_b = torch.cat([m for _, m in cand], dim=0)
    # the staging, the cap and the append
    rows_sl = slice(slot * W, (slot + 1) * W)
    stage_pix[rows_sl] = torch.where(sel_active, pix, R + slot * W + lanes)
    stage_contrib[rows_sl] = _where0(sel_active[:, None], contrib)
    capped = torch.clamp(start, max=Q_cap - 2 * W)
    dropped = dropped + (start - capped)
    m = masks_b & sel_active.repeat(len(cand))
    cum = torch.cumsum(m.to(torch.int64), dim=0)
    dest = torch.where(m, capped + cum - 1, torch.full_like(cum, pool.shape[0] - 1))
    pool.index_copy_(0, dest, rows_b)
    return capped + cum[-1], dropped


def _fused_iteration(scene, cfg, eps, pool, count, dropped, stage_pix, stage_contrib, slot,
                     R, W, Q_cap):
    """The same iteration through the five wrappers, as `fused_step` calls
    them; count and dropped updated in place. Returns the take's and the hit
    record's outputs."""
    taken = kernels.pool_take(pool, count, W=W)
    o, d, w, ior, budget, from_refl, pix, take = taken
    tt, tidx = kernels.cast_triangles(
        scene.trb_pack, scene.tri_cast_pack, scene.tri_aabb, scene.tri_saabb, o, d,
        backface_culling=cfg.backface_culling, sb_sizes=scene.sb_sizes)
    hit = kernels.pool_hit(scene.sph_pack, scene.mat_pack, o, d, tt, tidx, take,
                           backface_culling=cfg.backface_culling)
    contrib, rfl_rows, rfl_m, rfr_rows, rfr_m = kernels.shade_eval_rows(
        *trace._node_inputs(scene, hit, d, ior, w, budget, from_refl), pix,
        **trace._node_kw(scene, cfg, eps))
    kernels.pool_put(pool, count, dropped, stage_pix, stage_contrib, take, pix, contrib,
                     rfl_rows, rfl_m, rfr_rows, rfr_m, slot=slot, R=R, Q_cap=Q_cap,
                     reflections=cfg.reflections, refractions=cfg.refractions)
    return taken, hit


def _pool_state(children, backface):
    """(scene, cfg, eps, pool with the prologue's rows, their count, R, W, Q)
    of 512 primary rays of the TINY frame, the pool at W = 64."""
    cfg = RenderConfig(**TINY, backface_culling=backface, **CHILDREN[children])
    scene = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    eps = float(cfg.camera.epsilon_distance)
    R = 512
    cam = cfg.camera
    rng = np.random.default_rng(7)
    px, py = rng.integers(0, cfg.width, R), rng.integers(0, cfg.height, R)
    o = torch.from_numpy(np.stack([px * cam.w2s_width, py * cam.w2s_height, np.zeros(R)],
                                  -1).astype(np.float32))
    d = normalized(o - torch.tensor(cam.render_ray_focus, dtype=torch.float32))
    prim = (o, d, torch.full((R,), trace.AIR), torch.ones((R, 3)),
            torch.full((R,), -1, dtype=torch.int32), torch.zeros(R, dtype=torch.bool),
            torch.ones(R, dtype=torch.bool))
    _, _, rows0, masks0 = trace._node_rows(scene, cfg, eps, *prim,
                                           pix=torch.arange(R, dtype=torch.int64))
    W = 64
    Q = 2 * R + 2 * W * 12
    pool = torch.zeros((Q + 1, trace.POOL_COLS))
    count = trace._pool_append(pool, 0, rows0, masks0)
    return scene, cfg, eps, pool, int(count), R, W, Q


# count: a drained pool, one below W, the prologue's whole count (deeper
# than W), and a full pool at a capacity of 2.5 W, where the cap engages
COUNTS = ("drained", "below_w", "deep", "capped")


@pytest.mark.parametrize("backface", [False, True])
@pytest.mark.parametrize("children", sorted(CHILDREN))
@pytest.mark.parametrize("case", COUNTS)
def test_fused_iteration_twins_give_the_glue_bits(case, children, backface):
    scene, cfg, eps, pool, n, R, W, Q = _pool_state(children, backface)
    assert n > W, n
    Q_cap = Q
    if case == "drained":
        n = 0
    elif case == "below_w":
        n = W // 2 + 3
    elif case == "capped":
        Q_cap = 2 * W + W // 2
        n = min(n, Q_cap)
    state = dict(pool=pool, count=torch.tensor(n), dropped=torch.tensor(5),
                 stage_pix=torch.full((2 * W,), -7, dtype=torch.int64),
                 stage_contrib=torch.full((2 * W, 3), -1.0))
    ref = {k: v.clone() for k, v in state.items()}
    got = {k: v.clone() for k, v in state.items()}
    count, dropped = _glue_iteration(scene, cfg, eps, ref["pool"], ref["count"], ref["dropped"],
                                     ref["stage_pix"], ref["stage_contrib"], 1, R, W, Q_cap)
    ref["count"], ref["dropped"] = count, dropped
    kernels.reset_launch_counts()
    taken, hit = _fused_iteration(scene, cfg, eps, got["pool"], got["count"], got["dropped"],
                                  got["stage_pix"], got["stage_contrib"], 1, R, W, Q_cap)
    assert sum(kernels.LAUNCHES.values()) == 0  # the CPU takes the twins
    for k in state:
        assert same_bits(got[k], ref[k]), k
    start = max(n - W, 0)
    assert taken[-1].tolist() == [start, n]
    live = n - start
    assert int(hit[4].sum()) <= live and bool((hit[4][live:] == 0).all())
    assert bool((taken[0][live:] == 1e9).all())
    assert int(got["count"]) <= Q_cap
    if case == "capped":
        assert int(got["dropped"]) == 5 + start - (Q_cap - 2 * W) > 5
    else:
        assert int(got["dropped"]) == 5
    if case == "drained":
        assert int(got["count"]) == 0 and bool((got["stage_pix"][W:] >= R).all())


@pytest.mark.parametrize("frame", ["both", "refl", "refr", "backface", "capacity", "max_nodes"])
def test_fused_tiles_give_the_glue_colours_and_counts(frame, monkeypatch):
    """A whole tile of the pool path (`trace_rays`): the fused iterations
    (forced on the CPU, where the wrappers take the twins) against the
    glue's, to the same colour bits, dropped and unfinished rays."""
    kw = dict(TINY, **CHILDREN.get(frame, CHILDREN["both"]))
    kw.update({"backface": dict(backface_culling=True), "capacity": dict(pool_capacity=130),
               "max_nodes": dict(max_nodes=1)}.get(frame, {}))
    cfg = RenderConfig(**kw)
    scene = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    px = torch.arange(cfg.tile_rays)
    o = torch.stack([(px % cfg.width) * cfg.camera.w2s_width,
                     (px // cfg.width) * cfg.camera.w2s_height, torch.zeros(px.shape[0])],
                    -1).float()
    d = o - torch.tensor(cfg.camera.render_ray_focus, dtype=torch.float32)
    glue = trace.trace_rays(scene, cfg, o, d, with_stats=True)
    monkeypatch.setattr(trace, "_fuses", lambda *a: True)
    fused = trace.trace_rays(scene, cfg, o, d, with_stats=True)
    assert same_bits(fused[0], glue[0]) and torch.equal(fused[1], glue[1])
    assert {k: int(v) for k, v in fused[2].items()} == {k: int(v) for k, v in glue[2].items()}
    if frame == "capacity":
        assert int(glue[2]["dropped"]) > 0
    if frame == "max_nodes":
        assert int(glue[2]["unfinished"]) > 0


def test_fused_path_is_chosen_where_it_applies():
    """On a CUDA device with the packed node rows on a resident scene, and
    not in packet mode or with the Morton resort; never on the CPU."""
    cfg = RenderConfig(**TINY, **CHILDREN["both"])
    scene = build_device_scene(build("semesterbild", cfg), cfg, device="cpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert trace._fuses(scene, cfg, cuda) and not trace._fuses(scene, cfg, cpu)
    for off in (dict(packed_stage=False), dict(packet_mode=True),
                dict(resort_secondary=True)):
        assert not trace._fuses(scene, RenderConfig(**TINY, **CHILDREN["both"], **off), cuda)
    streamed = RenderConfig(**TINY, **CHILDREN["both"], stream_triangles=1)
    s_scene = build_device_scene(build("semesterbild", streamed), streamed, device="cpu")
    assert s_scene.streaming and not trace._fuses(s_scene, streamed, cuda)


# ---- on the card ----------------------------------------------------------

MAIN = dict(scene_backface_culling=True, tile_rays=131072, max_nodes=48, weight_cutoff=1e-3,
            compaction_ratio=64, kernel_ray_tile=512, loop_chunk=96, device_encode=True)
REALISTIC = dict(reflections=True, light_reflections=True, refractions=True)
EXTREME = dict(REALISTIC, anti_aliasing_rotation_scale=True, anti_aliasing_randomness=True,
               extreme_quality=True, high_quality_model=True)
CARD = {  # config, the pool width, the frame's checksum (chip_smoke.py)
    "realistic": (dict(width=1920, height=1080, **MAIN, **REALISTIC), 2048, "2f1bddf34a353be8"),
    "extreme": (dict(width=480, height=270, **dict(MAIN, tile_rays=262144), **EXTREME), 3584,
                "962119403fd43461"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: pytest -m gpu on the card)")
    trace.drop_pool_graphs()
    return torch.device("cuda")


def _caught(names, run, keep):
    """{name: [(index, args, kw)]} of the calls of kernels.<name> whose index
    `keep(index)` takes, tensor arguments cloned before the call."""
    wrappers = {n: getattr(kernels, n) for n in names}
    caught = {n: [] for n in names}
    seen = dict.fromkeys(names, 0)

    def catching(n):
        def catch(*a, **kw):
            if keep(seen[n]):
                caught[n].append((seen[n], [x.clone() if isinstance(x, torch.Tensor) else x
                                            for x in a], kw))
            seen[n] += 1
            return wrappers[n](*a, **kw)
        return catch

    for n in names:
        setattr(kernels, n, catching(n))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for n, w in wrappers.items():
            setattr(kernels, n, w)
    return caught, seen


@pytest.mark.gpu
@pytest.mark.parametrize("frame", sorted(CARD))
def test_card_pool_kernels_give_their_twins_bits(cuda, frame):
    """pool_take, pool_hit and pool_put against their twins (run on the same
    CUDA tensors) on tile 3's pool: its first iterations, one in the middle
    and its last, each also as a drained iteration (count 0); pool_put on
    copies of the state, the pool's rows below the dump row compared (the
    twin's scatter sends every rejected row to the dump row, in no fixed
    order on the card)."""
    kw, W, _ = CARD[frame]
    c = RenderConfig(**kw)
    scene = RaytracerRenderer(c, device=cuda).device_scene(build("semesterbild", c))
    names = ("pool_take", "pool_hit", "pool_put")
    _, seen = _caught(names, tile_call(scene, c, 3, aa=frame == "extreme"), lambda i: False)
    n = seen["pool_put"]
    assert n >= c.loop_chunk and seen["pool_take"] == seen["pool_hit"] == n, seen
    picks = {0, 1, n // 2, n - 1}
    caught, _ = _caught(names, tile_call(scene, c, 3, aa=frame == "extreme"),
                        lambda i: i in picks)
    assert len(caught["pool_put"]) == len(picks)
    for (i, args, kw_), (_, hargs, hkw), (_, pargs, pkw) in zip(
            caught["pool_take"], caught["pool_hit"], caught["pool_put"]):
        pool, count = args
        assert kw_["W"] == W and pool.shape[0] - 1 >= 2 * W
        for drained in (False, True):
            label = (frame, i, "drained" if drained else int(count))
            if drained:
                count = torch.zeros_like(count)
            got, ref = kernels.pool_take(pool, count, W=W), kernels.pool_take_plain(pool, count, W)
            assert all(same_bits(a, b) for a, b in zip(got, ref)), (label, "pool_take")
            take = got[-1]
            h = [take if j == 6 else x for j, x in enumerate(hargs)]
            got, ref = kernels.pool_hit(*h, **hkw), kernels.pool_hit_plain(*h, **hkw)
            assert all(same_bits(a, b) for a, b in zip(got, ref)), (label, "pool_hit")
            p = [take if j == 5 else x for j, x in enumerate(pargs)]
            k_state, p_state = ([x.clone() if isinstance(x, torch.Tensor) else x for x in p]
                                for _ in range(2))
            kernels.pool_put(*k_state, **pkw)
            kernels.pool_put_plain(*p_state, **pkw)
            for j, what in enumerate(("pool", "count", "dropped", "stage_pix", "stage_contrib")):
                a, b = k_state[j], p_state[j]
                if what == "pool":
                    a, b = a[:-1], b[:-1]
                assert same_bits(a, b), (label, "pool_put", what)


@pytest.mark.gpu
def test_card_fused_frames_keep_their_checksums(cuda):
    """The 1080p `realistic` and the 480x270 `extreme` frames through the
    fused iterations: chip_smoke.py's checksums, nothing dropped or left
    untraced, one pool_put, pool_take and pool_hit launch per pool
    iteration (one shade_eval_rows launch per iteration and per tile)."""
    for frame, (kw, _, sha) in CARD.items():
        c = RenderConfig(**kw)
        r = RaytracerRenderer(c, device=cuda)
        scene = r.device_scene(build("semesterbild", c))
        r.render_u32(scene)  # the first chunk of a key runs eagerly, the next is captured
        kernels.reset_launch_counts()
        px = r.render_u32(scene)
        assert hashlib.sha256(px.tobytes()).hexdigest()[:16] == sha, frame
        assert (r.last_dropped, r.last_unfinished) == (0, 0), frame
        n = kernels.LAUNCHES["pool_put"]
        n_tiles = kernels.LAUNCHES["shade_eval_rows"] - n
        assert n > 0 and n % c.loop_chunk == 0 and 0 < n_tiles <= 16, kernels.LAUNCHES
        assert kernels.LAUNCHES["pool_take"] == kernels.LAUNCHES["pool_hit"] == n, frame
