"""Helpers that chip_smoke.py, utils/ab.py and the card tests share: the
block partitions that the warp kernels must take, a tile of a frame as one
call, the calls of a kernel wrapper caught from a render, bitwise checks of
the node kernels, and timing by CUDA events and by torch.profiler.

utils/ab.py imports this file from its own directory (as `harness`), so
that it can measure through it the package of another checkout, one that
may lack this file.
"""

from __future__ import annotations

import numpy as np
import torch

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.ops import kernels, trace
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.renderer import plan_frame

# Block partitions that the JAX package takes (pallas_kernels.py:149-160)
# and that the kernels with a warp per ray take too
PARTITIONS = {
    # more than 32 Morton blocks in one superblock: rounds of 32 lanes
    "superblock64": dict(triangle_block=32, superblock=64),
    # blocks of 48 rows: a ragged last round of rows
    "block48": dict(triangle_block=48),
}


def same_bits(a, b):
    """Equal bit for bit, NaN included (the child fields of a ray without a
    hit may be NaN in the kernels and their twins alike)."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def flat(out):
    """A kernel's outputs as a flat list of tensors (dicts of fields opened)."""
    items = []
    for x in out:
        items += list(x.values()) if isinstance(x, dict) else [x]
    return items


def assert_node_bits(rows_out, fields_out, label=""):
    """shade_eval_rows and shade_eval on the same inputs: contrib, every
    child field and the masks bit for bit, rays without a hit included."""
    contrib, rfl, rfl_m, rfr, rfr_m = rows_out
    f_contrib, f_rfl, f_rfr = fields_out
    label = f"{label} ({contrib.shape[0]} rays)"
    assert same_bits(contrib, f_contrib), f"{label}: contrib bits"
    for rows, m, f in ((rfl, rfl_m, f_rfl), (rfr, rfr_m, f_rfr)):
        assert torch.equal(m, f["mask"]), f"{label}: masks"
        assert same_bits(rows[:, 0:9], torch.cat([f["o"], f["d"], f["w"]], 1)), label
        assert same_bits(rows[:, 10], f["budget"].float()), label
    assert same_bits(rfr[:, 9], f_rfr["ior"]), label


def tile_call(scene, c, k, device="cuda"):
    """A call that renders tile k of the frame of config c (one sample per
    pixel) on `scene`."""
    plan = plan_frame(c)
    n = plan.pix_per_tile
    order = np.full((n,), -1, np.int64)  # -1: a padding slot past the frame
    part = plan.order[k * n: (k + 1) * n]
    order[:part.shape[0]] = part
    order = torch.from_numpy(order).to(device)
    per_tile = trace.make_raygen_per_tile(scene, c, torch.zeros((1, 3), device=device),
                                          torch.ones(1, device=device), n)
    return lambda: per_tile(order)


def caught_calls(names, run, limit=None):
    """{name: the first `limit` (None: all) calls of kernels.<name> while
    `run` runs, as (args, kw)}, tensor arguments copied (the pool and the
    stack reuse their buffers)."""
    wrappers = {name: getattr(kernels, name) for name in names}
    caught = {name: [] for name in names}

    def catching(name):
        def catch(*a, **kw):
            if limit is None or len(caught[name]) < limit:
                caught[name].append(([x.clone() if isinstance(x, torch.Tensor) else x
                                      for x in a], kw))
            return wrappers[name](*a, **kw)
        return catch

    for name in names:
        setattr(kernels, name, catching(name))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, wrapper in wrappers.items():
            setattr(kernels, name, wrapper)
    return caught


def cuda_ms(fn, iters, warmup=3):
    """The mean time of fn() by CUDA events: the wrapper's host work and its
    kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters, per_call=1):
    """Device time of one call's CUDA kernels written in this repository,
    all of them (torch.profiler; the mean over `iters` calls): what CUDA
    events cannot show for a kernel shorter than its wrapper's time on the
    host. `per_call`: the launches of one call (None: any whole number).
    None if no trace of three caught the launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a trace may miss launches, now and then all of them
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages() if "anonymous namespace" in e.key]
        n = sum(e.count for e in ours)
        total = sum(e.self_device_time_total for e in ours) / 1e3
        if per_call is None:
            if n and n % iters == 0:
                return total / iters
            continue
        assert n <= iters * per_call, [(e.key, e.count) for e in ours]
        if n == iters * per_call or (n and per_call == 1):
            return total / n * per_call
    return None
