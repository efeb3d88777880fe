"""The frame benchmark of the PyTorch and CUDA port, one cell per run.

    python3 frame_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. It prints one JSON object as the last line of standard output
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, then `checks`), and the numbers compared with their limits
as the last lines of standard error. It exits with another code than 0, and
prints no result, without enough cards, when the port cannot be imported,
or when JAX or the JAX package is loaded in this process once the window
has closed. Build and kernel caches stay inside the checkout.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    # every cache at a fixed path inside the checkout
    cache = os.path.join(ROOT, "build", "frame_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path[:0] = [BENCH_DIR, ROOT]

    from framebench import cell, spec

    workload = spec.cell(spec.load_benchmark(ROOT), args.workload)
    try:
        from framebench import port  # noqa: F401 (the system under test)
    except ImportError as e:
        print(f"the system under test cannot be imported: {e}", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0", t_start=T_START)
    bad = cell.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
