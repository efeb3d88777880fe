"""The readings that the limits of `correct` are set from, at a cell's own
size, on the card, in one process:

    python3 frame_bench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--out FILE]

For each seed: the program's second frame (render_u32 on a fresh device
scene of that seed, the frame a timed window renders) against the float32
reference (the lower readings); for each control seed also the reference
computed in bfloat16, the control (the upper readings), and two faults
planted in the program's frame: half of its tiles left black, and one
tile's pixels altered. Prints one JSON line per seed and the summary: each
number's largest sound reading and smallest control reading. The reference
and its control are the module the cell's configuration names
(`spec.reference`). The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from framebench import compare, port, spec  # noqa: E402


def tile_pixels(width, height, pix_per_tile, ts=16):
    """Row-major pixel indices of each tile: 16x16 patches in tile-major
    order, cut into tiles of `pix_per_tile` pixels."""
    idx = np.arange(width * height).reshape(height, width)
    order = np.concatenate([idx[y:y + ts, x:x + ts].reshape(-1)
                            for y in range(0, height, ts) for x in range(0, width, ts)])
    return [order[s:s + pix_per_tile] for s in range(0, order.shape[0], pix_per_tile)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell)
    reference_frame = spec.reference(cfg).reference_frame
    traffic = spec.traffic(cell)
    W, H = int(traffic["width"]), int(traffic["height"])
    dev = torch.device("cuda:0")
    tiles = tile_pixels(W, H, int(cfg["render"]["tile_rays"]))
    rows = []
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.monotonic()
        raw = spec.scene_module(cfg["scene"]).build(W, H, seed, cfg["seed_offset_bound"])
        prog = port.Port(cfg["render"], W, H, seed, raw, dev)
        first = prog.frame()[0]
        px, dropped, unfinished = prog.frame()
        prog.close()
        del prog
        torch.cuda.empty_cache()
        ref = reference_frame(raw, cfg["render"], W, H, seed, dev)
        row = dict(seed=seed, same_bits=bool(np.array_equal(first, px)), dropped=dropped,
                   unfinished=unfinished, program=compare.frame_numbers(px, ref))
        if seed in args.control_seeds:
            ctl = reference_frame(raw, cfg["render"], W, H, seed, dev, torch.bfloat16)
            row["control"] = compare.frame_numbers(ctl, ref)
            half = px.copy()
            for t in tiles[::2]:
                half[t] = 0
            row["half_the_tiles_left_out"] = compare.frame_numbers(half, ref)
            altered = px.copy()
            t = tiles[len(tiles) // 2]
            altered[t] = np.where(altered[t] != 0, altered[t] ^ np.uint32(0x404040), 0)
            row["one_tile_altered"] = compare.frame_numbers(altered, ref)
        row["seconds"] = time.monotonic() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in rows[0]["program"]:
        summary[key] = {"lower": max(r["program"][key] for r in rows if r["seed"] in args.seeds)}
        for kind in ("control", "half_the_tiles_left_out", "one_tile_altered"):
            vals = [r[kind][key] for r in rows if kind in r]
            if vals:
                summary[key][kind] = min(vals)
    out = dict(workload=args.workload, device=torch.cuda.get_device_name(dev), rows=rows,
               summary=summary)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
