"""One run of one cell of the benchmark, from the root of a checkout:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's model from the seed, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference and prints one JSON line last on standard output (the checks,
each beside its limit, last on standard error). With ``--trace 1`` the line
holds the cell's per-layer metrics, read from a profiler trace of a short
stretch of the window, and the device's busy time; without, its end-to-end
metrics. A run that finds no card, or fewer than the cell asks for, exits
with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads
    JAX on its own."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    try:
        from bench.harness import HarnessError, print_result, run_cell
    except ImportError as e:
        print(f"bench: cannot load the harness: {e}", file=sys.stderr)
        return 2
    try:
        out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", T_START)
    except (HarnessError, ImportError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
