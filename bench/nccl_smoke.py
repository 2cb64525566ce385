"""Four ranks of one cell's training step over NCCL, one card a rank: the
path of a four-chip cell, tried before such a cell is built.

    python3 bench/nccl_smoke.py --workload CELL --ranks 4 --steps 8 --seed N

Each rank joins one process group (`repro_torch.launch.mesh.ProcessMesh`,
a data 4 x model 1 mesh over `tcp://localhost`), builds the cell's model
and one `DQGAN` of `--ranks` workers over the mesh (exchange `sim`: the
mean of the workers' dequantized messages), makes the same weights and
the same global batches from the seed (each rank takes its worker's rows,
the cell's batch a worker), takes two warm-up steps, times `--steps`
steps (each ending in a synchronize), and traces two more. Rank 0 prints
one JSON line: the step time of each rank, the peak memory of each, the
device time of the NCCL kernels a step on each, the losses, and the
largest gap between the ranks' parameters after the steps, which the
common mean update keeps at 0. `--device-type cpu` runs the same over
gloo, on a tiny cell of a scratch checkout (`--root`), as a rehearsal.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import traceback  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _paths(root: Path):
    for p in (root, root / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def rank_main(rank, world, port, args, q):
    try:
        q.put((rank, True, _rank(rank, world, port, args)))
    except BaseException:   # reported to the parent, which fails the run
        q.put((rank, False, traceback.format_exc()))


def _rank(rank, world, port, args):
    root = Path(args.root)
    _paths(root)
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from bench import cell as CELL
    from bench import inputs, spec
    from bench import trace as TR
    from repro_torch.core import dqgan
    from repro_torch.launch.mesh import ProcessMesh

    cuda = args.device_type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    mesh = ProcessMesh.init(rank, world, device_type=args.device_type,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=600)
    try:
        device = mesh.device
        c = spec.load_cell(args.workload, root)
        plan = CELL.Plan(c)
        tr = c.traffic
        weights = inputs.make_weights(plan.wspec, args.seed, device)
        trainer = dqgan.DQGAN(field_fn=plan.bundle.field_fn,
                              dq=spec.strategy(tr, spans=False),
                              device=device,
                              seed=inputs.sub_seed(args.seed, 3),
                              workers=world, mesh=mesh)
        state = trainer.init(inputs.nest(weights))
        del weights
        nb = 4
        batches = inputs.make_batches(nb, world * tr["batch"], tr["seq"],
                                      plan.m["vocab_size"], args.seed,
                                      device)

        def step(i):
            out = trainer.step(state, batches[i % nb])
            CELL.sync(device)
            return out

        for i in range(2):
            state = step(i).state
        mesh.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        losses = []
        t0 = time.perf_counter()
        for i in range(args.steps):
            out = step(2 + i)
            state = out.state
            losses.append(float(out.metrics["loss"]))
        step_ms = (time.perf_counter() - t0) / args.steps * 1e3
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        mesh.barrier()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            for i in range(2):
                state = step(2 + args.steps + i).state
        # the NCCL kernels' own intervals on the device, each once
        nccl_us = sum(end - start for name, start, end, _, _
                      in TR.from_profiler(prof).device
                      if "nccl" in name.lower())
        # each leaf's sum and sum of squares in float64: the ranks' copies
        # of the parameters, compared
        leaves = [t for t in CELL.flat(state.params).values()
                  if torch.is_tensor(t)]
        fp = torch.stack([torch.stack([t.double().sum(),
                                       t.double().square().sum()])
                          for t in leaves])
        got = [torch.empty_like(fp) for _ in range(world)]
        dist.all_gather(got, fp)
        gap = max(float(((g - got[0]).abs() / (got[0].abs() + 1e-30)).max())
                  for g in got)
        return {"rank": rank, "step_ms": step_ms, "steps": args.steps,
                "peak_mem_gib": peak / 2 ** 30,
                "nccl_ms_step": nccl_us / 2 / 1e3,
                "losses": losses, "param_gap_between_ranks": gap,
                "seconds_since_start": time.perf_counter() - T_START}
    finally:
        mesh.close()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device-type", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    root = Path(args.root)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    if args.device_type == "cuda":
        import torch
        if torch.cuda.device_count() < args.ranks:
            print(f"nccl_smoke: {args.ranks} cards needed, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True)
        print(topo.stdout + topo.stderr, file=sys.stderr)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, args.ranks, port, args, q))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    results, ok = {}, True
    deadline = time.monotonic() + args.timeout
    try:
        while len(results) < args.ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                ok = False
                print("nccl_smoke: ranks timed out", file=sys.stderr)
                break
            try:
                r, good, out = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    ok = False
                    print("nccl_smoke: a rank died", file=sys.stderr)
                    break
                continue
            results[r] = out
            if not good:
                ok = False
                print(f"nccl_smoke: rank {r} failed:\n{out}",
                      file=sys.stderr)
                break
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if not ok:
        return 1
    print(json.dumps({"workload": args.workload, "ranks": args.ranks,
                      "device_type": args.device_type,
                      "per_rank": [results[r] for r in sorted(results)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
