"""Training launcher of the port: single-worker DQGAN on a GAN arch, on one
CUDA device (or the CPU when asked).

    python -m repro_torch.launch.train --arch dcgan32 --steps 20 \
        --optimizer omd --compressor qsgd8_block1024 --comm-plan uniform

The strategy flags are the JAX launcher's, generated from the same
component schemas (``--preset``, ``--strategy-json``, ``--compressor``,
``--comm-plan``, ...). Log rows are the JAX launcher's JSON lines where
the port has the field (``loss``, ``grad_norm``, ``error_norm``,
``wire_mb_step``, ``cum_wire_mb``, ``comm_ratio``) plus ``step_s``, the
step's wall time ending in a device synchronize.

``--device`` defaults to ``cuda`` and the launcher exits with an error
when no CUDA device is present; ``--device cpu`` runs the kernels' plain
versions on the CPU. On CUDA the trainer turns TF32 off for matmuls and
convolutions: the reference computes in float32. Strategies the port does not run yet
(other schedules, partial participation, fsdp, ...) are refused with the
ROADMAP slice that brings them.
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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
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
    try:
        strat = strategy_api.strategy_from_args(args, worker_axes=())
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
                        seed=args.seed + 1)
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
        ledger.tick()
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in out.metrics.items()}
            rec = {"step": i, "round": i,
                   "loss": m["loss"],
                   "grad_norm": m["grad_norm"],
                   "error_norm": m["error_norm"],
                   "wire_mb_step": round(ledger.wire_bytes_per_step / 1e6, 3),
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
