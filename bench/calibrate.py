"""The readings that the limits of `bench/limits/<cell>.json` are set
from, at the cell's own size, on the card, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3

For each of `--seeds` seeds, the program's checked steps (as a run of the
cell makes them) against the float32 reference: the lower readings. For
the first `--control-seeds` of them also the control, the reference
computed with float8 e4m3 operands in every linear layer, and the fault of
half the batch left out (the reference on the first half, its mean taken
over it), each against the float32 reference: the upper readings. A
state left unchanged reads 1 on the change numbers and needs no run. One
JSON line a seed and kind goes to standard output and, with `--out`, to
that file.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=JSON",
                    help="change a key of the configuration's model (a "
                         "witness at another depth or precision)")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")

    import torch

    from bench import cell as CELL
    from bench import correct, spec
    device = torch.device(args.device)
    c = spec.load_cell(args.workload, ROOT)
    for kv in args.set:
        k, v = kv.split("=", 1)
        c.config["model"][k] = json.loads(v)
    plan = CELL.Plan(c)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        trainer, state, batches, prog = CELL.program_steps(
            plan, seed, False, device, log=lambda s: None)
        del trainer, state
        CELL.free(device)
        ref = CELL.reference_readings(plan, seed, batches, device)
        where = {}
        emit({"cell": args.workload, "set": args.set, "seed": seed,
              "kind": "program",
              "numbers": correct.numbers(prog, ref, where), "where": where,
              "loss": prog["loss"],
              "ref_loss": ref["loss"],
              "seconds": time.perf_counter() - t0})
        if k < args.control_seeds and not args.no_control:
            for kind, kw in (("control_fp8", {"compute": "fp8"}),
                             ("fault_half_batch", {"half_batch": True})):
                t0 = time.perf_counter()
                other = CELL.reference_readings(plan, seed, batches, device,
                                                **kw)
                where = {}
                emit({"cell": args.workload, "seed": seed, "kind": kind,
                      "numbers": correct.numbers(other, ref, where),
                      "where": where,
                      "loss": other["loss"],
                      "seconds": time.perf_counter() - t0})
                del other
                CELL.free(device)
        del ref, prog, batches
        CELL.free(device)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
