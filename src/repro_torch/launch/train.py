"""Training launcher of the port: DQGAN over W workers on a GAN arch, on
one CUDA device (or the CPU when asked).

    python -m repro_torch.launch.train --arch dcgan32 --steps 20 \
        --optimizer omd --compressor qsgd8_block1024 --comm-plan uniform
    python -m repro_torch.launch.train --arch dcgan32 --workers 4 \
        --batch 256 --optimizer omd --lr 1e-4 --compressor qsgd8_block1024 \
        --comm-plan delta_budget --comm-budget-mb 0.75 --comm-adaptive \
        --participation 0.5 --exchange sim --steps 20

``--workers W`` (default 1) stands for the JAX launcher's device count:
the W workers are a leading axis of every per-worker tensor on the one
device (`core.exchange.StackedWorkers`), and ``--batch`` is the global
batch, split W ways in order. There is no model axis, so no leaf is
sharded and every leaf is bucketed.

The strategy flags are the JAX launcher's, generated from the same
component schemas (``--preset``, ``--strategy-json``, ``--compressor``,
``--comm-plan``, ...). Log rows are the JAX launcher's JSON lines where
the port has the field (``loss``, ``grad_norm``, ``error_norm``,
``wire_mb_step``, ``cum_wire_mb``, ``comm_ratio``, and ``participants``
under partial participation) plus ``step_s``, the step's wall time ending
in a device synchronize. Each round is billed at what its participants
move: ``wire_mb_step`` is the ledger's ``round_bytes(n)``, the selected
PlanFamily member's bytes under an adaptive plan.

``--device`` defaults to ``cuda`` and the launcher exits with an error
when no CUDA device is present; ``--device cpu`` runs the kernels' plain
versions on the CPU. On CUDA the trainer turns TF32 off for matmuls and
convolutions: the reference computes in float32. Strategies the port does not run yet
(other schedules, spmd='vmap', fsdp, ...) are refused with the ROADMAP
slice that brings them.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch import strategy as strategy_api
from repro_torch.configs.base import DQConfig
from repro_torch.core.dqgan import DQGAN
from repro_torch.data import procedural_images
from repro_torch.models import gan
from repro_torch.sched import n_participants


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the workers")
    ap.add_argument("--workers", type=int, default=1,
                    help="DQGAN workers, stacked on the one device (the "
                         "JAX launcher's device count)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="oadam")
    strategy_api.add_strategy_args(ap)
    ap.add_argument("--log-every", type=int, default=1,
                    help="log row every N steps (default: every step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) needs a GPU, "
                         "'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run on the CPU)")
    try:
        cfg = configs.get(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if args.smoke:
        cfg = cfg.reduced()
    W = args.workers
    if W < 1 or args.batch % W:
        ap.error(f"--batch {args.batch} must split over --workers {W}")
    try:
        strat = strategy_api.strategy_from_args(
            args, worker_axes=("data",) if W > 1 else ())
    except strategy_api.StrategyError as e:
        ap.error(str(e))
    if strat.participation.straggler_profile != "none":
        ap.error("the straggler wall-clock model arrives with ROADMAP §A "
                 "slice 3 (schedules); repro_torch does not run it yet")
    dq = DQConfig.from_strategy(
        strat, optimizer=args.optimizer, lr=args.lr,
        message="update" if args.optimizer == "omd" else "grad")
    try:
        trainer = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=dq, device=device,
                        seed=args.seed + 1, workers=W)
    except NotImplementedError as e:
        ap.error(str(e))

    # one stream for the initial weights and then the data batches
    data_gen = torch.Generator(device=device).manual_seed(args.seed)
    params = gan.init(cfg, generator=data_gen, device=device)
    state = trainer.init(params)
    ledger = trainer.comm_ledger(params)
    if strat.compression.bucketing:
        layout, cplan = trainer._comm(params)
        print(f"# comm: {layout.describe()}", flush=True)
        print(f"# comm: {cplan.describe()}", flush=True)
        family = trainer._family(params)
        if family is not None:
            print(f"# comm: {family.describe()}", flush=True)
    # count-exact participation: each round has n participants, billed at
    # what they move (the selected family member under an adaptive plan)
    n_part = (n_participants(strat.participation.fraction, W)
              if W > 1 and strat.participation.partial else None)
    print(f"# strategy: {strat.describe()} [{strat.short_hash()}]",
          flush=True)
    print(f"# device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)

    history = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {"real": procedural_images(args.batch, cfg.image_size,
                                           cfg.channels, generator=data_gen,
                                           device=device)}
        _sync(device)
        it_t0 = time.perf_counter()
        out = trainer.step(state, batch)
        state = out.state
        _sync(device)
        step_s = time.perf_counter() - it_t0
        ledger.tick(participants=n_part)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in out.metrics.items()}
            rec = {"step": i, "round": i,
                   **({"participants": n_part}
                      if n_part is not None else {}),
                   "loss": m["loss"],
                   "grad_norm": m["grad_norm"],
                   "error_norm": m["error_norm"],
                   "wire_mb_step": round(
                       ledger.round_bytes(n_part)[0] / 1e6, 3),
                   "cum_wire_mb": round(ledger.cumulative_wire_bytes / 1e6,
                                        2),
                   "comm_ratio": round(ledger.compression_ratio, 2),
                   "step_s": round(step_s, 6),
                   "elapsed_s": round(time.time() - t0, 1)}
            history.append(rec)
            print(json.dumps(rec), flush=True)
    return history


if __name__ == "__main__":
    main()
