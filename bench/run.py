"""Run one cell of the benchmark once, on the machine it is started on:

    python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is the
result, one JSON object; the numbers that decide `correct` are the last
lines of standard error. Exits non-zero with no result where CUDA or the
cell's cards are missing, where the program cannot be imported, and where
JAX or the JAX package was loaded.

Build caches stay inside the checkout at fixed paths: the port's kernels
under `build/kernels`, Triton's under `build/triton`.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the script's own folder is not a place to import from: its modules are
# the package `bench`'s
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from bench import cell as CELL
    from bench import spec

    c = spec.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"bench: {args.workload} needs {c.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, err = CELL.run(c, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    bad = CELL.forbidden_modules()
    if bad and result is not None:
        result = None
        err.append(f"bench: modules of JAX or of the JAX package loaded: "
                   f"{bad}")
    sys.stdout.flush()
    if result is not None:
        print(json.dumps(result), flush=True)
    for line in err:
        print(line, file=sys.stderr)
    return 0 if result is not None else 3


if __name__ == "__main__":
    sys.exit(main())
