"""Training launcher of the port: DQGAN over W workers on any arch of the
port (the GAN of the paper, or an LM of the zoo through its loss), on one
CUDA device (or the CPU when asked), or across the processes of a
`torchrun` launch.

    python -m repro_torch.launch.train --arch dcgan32 --steps 20 \
        --optimizer omd --compressor qsgd8_block1024 --comm-plan uniform
    python -m repro_torch.launch.train --arch starcoder2-7b --smoke \
        --seq 64 --steps 5 --compressor qsgd8_block1024 --comm-plan uniform
    python -m repro_torch.launch.train --arch dcgan32 --workers 4 \
        --batch 256 --optimizer omd --lr 1e-4 --compressor qsgd8_block1024 \
        --comm-plan delta_budget --comm-budget-mb 0.75 --comm-adaptive \
        --participation 0.5 --exchange sim --steps 20

The field is `models.build(cfg).field_fn`: the WGAN field on a GAN arch,
fed procedural images; on an LM the gradient of its loss (cross-entropy
plus the MoE router's aux losses), fed `data.lm_batch_iterator` batches
of ``--batch`` rows of ``--seq`` tokens (default 64, as in JAX), and an
encoder-decoder model's (whisper) encoder inputs of (enc_seq, d_model)
a row. Both draw from one data generator after the initial weights.

``--workers W`` (default 1) stands for the JAX launcher's device count:
the W workers are a leading axis of every per-worker tensor on the one
device (`core.exchange.StackedWorkers`), and ``--batch`` is the global
batch, split W ways in order. One process has no model axis, so every
leaf is bucketed.

Under ``torchrun`` (RANK and WORLD_SIZE set) the launcher joins the
process group (`launch.mesh.ProcessMesh`: nccl on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``) as a (data, model) mesh by the JAX
launcher's rule: a 'model' axis of 2 when the world size is even and
above 2, outside fsdp, else 1. The parameters are laid out over 'model'
by `parallel.sharding`'s rules (`models.build(cfg, mesh)`: each rank
holds its shards), and the W workers spread over the data ranks, W / data
each (`core.exchange.ProcessGroupWorkers`); ``--workers`` stays the
global W. The model-sharded leaves bypass the buckets (a ``# comm:
WARNING`` line says how many) and take the per-tensor path. The axis
covers every arch. Every rank draws the same global batch and takes its
data rows; rank 0 prints. Checkpoints gather the model shards and the
worker rows to rank 0 and hold what a one-process run saves, with the
mesh in a sharded directory's manifest (one file a rank by default); a
resume slices each rank's part, and says ``# resume: resharding ...``
when the saved mesh differs.

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch dcgan32 --smoke --device cpu --workers 2 --optimizer omd \
        --compressor qsgd8_block1024 --comm-plan uniform --steps 3

The strategy flags are the JAX launcher's, generated from the same
component schemas (``--preset``, ``--strategy-json``, ``--compressor``,
``--comm-plan``, ...). Log rows are the JAX launcher's JSON lines where
the port has the field (``loss``, ``grad_norm``, ``error_norm``,
``wire_mb_step``, ``cum_wire_mb``, ``comm_ratio``, and ``participants``
under partial participation) plus ``step_s``, the step's wall time ending
in a device synchronize. Each round is billed at what its participants
move: ``wire_mb_step`` is the ledger's ``round_bytes(n)``, the selected
PlanFamily member's bytes under an adaptive plan.

Execution schedule (``--schedule every_step|local_k|delayed``,
``--local-k K``, ``--staleness-tau τ``, or a ``tau_vector`` through
``--strategy-json``): the launcher decides each step's ``do_exchange``
from the schedule, and rows carry ``round`` and the simulated wall clock
``sim_clock_s`` of the straggler-aware cost model (``sched.clock``,
``--straggler-profile none|mild|heavy``), and under ``delayed`` the
steps' ``staleness_max``/``staleness_mean``, as the JAX launcher's rows
do.

Checkpointing: ``--checkpoint PATH`` saves the full ``DQState`` at the
end and every ``--checkpoint-every N`` steps, in the JAX package's
format (a path ending in ``.npz`` is one archive, anything else a
sharded directory of ``--checkpoint-shards`` files); ``--resume PATH``
restores it (either format, saved by either package), refuses a
checkpoint saved under another strategy with the field diff, and
continues at the saved step, the batch stream advanced past the steps
already taken.

``--device`` defaults to ``cuda`` and the launcher exits with an error
when no CUDA device is present; ``--device cpu`` runs the kernels' plain
versions on the CPU. On CUDA the trainer turns TF32 off for matmuls and
convolutions: the reference computes in float32. ``--overlap`` under
``--schedule delayed`` (and ``--preset ssp_server``) starts each round's
exchange before the field, on a second CUDA stream.

Compressed-gradient FSDP (``--preset fsdp_zero2|fsdp_zero3``, or
``--parallelism fsdp --zero-stage 2|3 --moment-compressor C
--moment-ef``): the optimizer state shards over the workers, the
gradients ride a (compressed) reduce-scatter and the update or parameter
shards a quantized all-gather; the ``# comm: fsdp`` line bills both legs,
and ``wire_mb_step`` is their sum. ``--spmd vmap`` runs the JAX package's
vmap step (``sim`` per leaf, no kernel) on stacked workers; under
torchrun it is refused:

    python -m repro_torch.launch.train --arch dcgan32 --workers 4 \
        --batch 256 --optimizer omd --lr 1e-4 --preset fsdp_zero3 \
        --compressor qsgd8_block1024 --moment-compressor qsgd8_block1024

Observability (`repro_torch.obs`, the JAX launcher's flags and events):
``--obs-sink PATH`` writes the versioned JSONL event stream (``run_meta``,
``train_log``, ``timing``, ``obs_metrics``, ``comm_summary``, ``profile``)
that ``python -m repro_torch.obs report PATH`` and ``python -m repro.obs
report PATH`` both read; ``--obs-sink ''`` (the default) prints the log
rows on stdout exactly as without it, ``stdout`` adds the other events as
``# obs[kind]`` lines, ``null`` prints none. ``--obs-metrics wire|full``
adds the step's telemetry (empirical δ̂ per bucket, EF norms, message
moments, staleness histogram), ``--obs-spans`` the ``repro.obs/<phase>``
profiler ranges, ``--profile-steps N`` (or ``--obs-profile``) one
``profile`` event over the first N steps, with kernels per phase when
spans are on, and ``--profile-trace-dir DIR`` a Chrome trace of the
window. With spans on, a phase clock (`repro_torch.obs.tracing.PhaseClock`)
times the window's spans too: the event's ``phase_ms`` holds each span's
count and its device, device-self and host milliseconds a step (CUDA
events and the host clock on one timeline), ``host_gap_ms`` the wall
time a step in which the device ran none of the step's phases; the
report prints both. Under torchrun only rank 0 writes:

    python -m repro_torch.launch.train --arch dcgan32 --steps 20 \
        --compressor qsgd8_block1024 --comm-plan uniform \
        --obs-metrics full --obs-spans --profile-steps 8 --obs-sink run.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zipfile

import torch

from repro_torch import checkpoint
from repro_torch import configs
from repro_torch import obs as obs_api
from repro_torch import strategy as strategy_api
from repro_torch.configs.base import DQConfig
from repro_torch.core.dqgan import DQGAN
from repro_torch.data import lm_batch_iterator, procedural_images
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import build, gan, param_specs
from repro_torch.sched import clock as sclock
from repro_torch.sched import n_participants
from repro_torch.sched import straggler as sstrag


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parser() -> argparse.ArgumentParser:
    """The launcher's argument parser."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a row of an LM batch")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the workers")
    ap.add_argument("--workers", type=int, default=1,
                    help="DQGAN workers (the JAX launcher's device "
                         "count): stacked on the one device, or spread "
                         "over the ranks under torchrun")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="oadam")
    strategy_api.add_strategy_args(ap)
    ap.add_argument("--checkpoint", default="",
                    help="save the full DQState here (end of run + "
                         "--checkpoint-every). A path ending in .npz "
                         "uses the single-archive format; anything else "
                         "is a sharded directory (manifest + shard files)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="also save every N steps (0 = only at the end)")
    ap.add_argument("--checkpoint-shards", type=int, default=0,
                    help="shard-file count for the sharded checkpoint "
                         "format (0 = one a process)")
    ap.add_argument("--resume", default="",
                    help="restore a full DQState checkpoint (either "
                         "format, saved by this package or the JAX one) "
                         "and continue from its step")
    ap.add_argument("--log-every", type=int, default=1,
                    help="log row every N steps (default: every step)")
    ap.add_argument("--obs-sink", default="", metavar="PATH",
                    help="run-sink backend: '' (quiet stdout, the "
                         "default rendering), 'stdout' (verbose), "
                         "'null', or a JSONL file path for "
                         "`python -m repro_torch.obs report`")
    ap.add_argument("--profile-steps", type=int, default=0, metavar="N",
                    help="profile a window of N steps and emit one "
                         "schema-v2 `profile` event into the sink "
                         "(repro_torch.obs.profile; implies profiling on "
                         "— --obs-profile alone uses the default window)")
    ap.add_argument("--profile-trace-dir", default="", metavar="DIR",
                    help="also keep a torch.profiler Chrome trace of the "
                         "profiled window in DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) needs a GPU, "
                         "'cpu' runs the kernels' plain versions")
    return ap


def main(argv=None):
    ap = parser()
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
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        model = model_axis_size(world, strat.exchange.fsdp)
        if W % (world // model):
            ap.error(f"--workers {W} must split over {world // model} "
                     f"data ranks")
        mesh = ProcessMesh.from_env(device.type, model=model)
        device = mesh.device
    try:
        return _train(args, ap, cfg, device, mesh, strat)
    finally:
        if mesh is not None:
            mesh.close()


def model_axis_size(world: int, fsdp: bool) -> int:
    """The JAX launcher's rule for the 'model' axis: 2 when the world size
    is even and above 2, outside fsdp (whose flat shard buckets need
    every leaf replicated), else 1."""
    return 2 if world % 2 == 0 and world > 2 and not fsdp else 1


def _train(args, ap, cfg, device, mesh, strat=None):
    W = args.workers
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    if strat is None:
        try:
            strat = strategy_api.strategy_from_args(
                args, worker_axes=("data",) if W > 1 else ())
        except strategy_api.StrategyError as e:
            ap.error(str(e))
    sched = strat.schedule.runtime()
    dq = DQConfig.from_strategy(
        strat, optimizer=args.optimizer, lr=args.lr,
        message="update" if args.optimizer == "omd" else "grad")
    bundle = build(cfg, mesh)
    try:
        trainer = DQGAN(field_fn=bundle.field_fn, dq=dq, device=device,
                        seed=args.seed + 1, workers=W, mesh=mesh,
                        param_specs=param_specs(cfg, mesh, args.seq))
    except ValueError as e:
        ap.error(str(e))

    # one stream for the initial weights and then the data batches
    data_gen = torch.Generator(device=device).manual_seed(args.seed)
    params = bundle.init(generator=data_gen, device=device,
                         max_seq=args.seq)
    state = trainer.init(params)

    workers = trainer.worker_backend
    shards = trainer.state_shards(state)
    mesh_rec = None if mesh is None else mesh.describe()

    def save_ckpt(path, st):
        meta = {"strategy": strat.to_json()}
        if path.endswith(".npz"):
            checkpoint.save(path, st, step=st.step, meta=meta,
                            workers=workers, shards=shards)
        else:
            checkpoint.save_sharded(path, st, step=st.step, meta=meta,
                                    n_shards=args.checkpoint_shards or None,
                                    mesh=mesh_rec, workers=workers,
                                    shards=shards)

    start = 0
    if args.resume:
        try:
            checkpoint.verify_strategy(args.resume, strat)
            if checkpoint.is_sharded(args.resume):
                saved_mesh = checkpoint.read_manifest(
                    args.resume).get("mesh")
                if saved_mesh != mesh_rec:
                    say(f"# resume: resharding {saved_mesh} -> {mesh_rec}",
                        flush=True)
                state = checkpoint.restore_sharded(args.resume, state,
                                                   workers=workers,
                                                   shards=shards)
            else:
                state = checkpoint.restore(args.resume, state,
                                           workers=workers, shards=shards)
        except (ValueError, OSError, zipfile.BadZipFile) as e:
            # strategy or shape mismatch, missing file, corrupt archive
            raise SystemExit(f"--resume refused:\n{e}") from None
        start = state.step
        say(f"# resumed from {args.resume} at step {start}", flush=True)
    ledger = trainer.comm_ledger(params)
    sk_n, sk_bytes = ledger.skipped_leaves()
    if sk_n:
        # the model-sharded leaves ride the per-tensor path: said once
        say(f"# comm: WARNING {sk_n} sharded leaf(s) bypass bucketing "
            f"({sk_bytes / 1e6:.2f} MB/step on the per-tensor path)",
            flush=True)
    if strat.compression.bucketing:
        layout, cplan = trainer._comm(params)
        say(f"# comm: {layout.describe()}", flush=True)
        say(f"# comm: {cplan.describe()}", flush=True)
        family = trainer._family(params)
        if family is not None:
            say(f"# comm: {family.describe()}", flush=True)
        if strat.exchange.fsdp:
            ex, mom = strat.exchange, strat.moments
            say(f"# comm: fsdp zero-{ex.zero_stage}: reduce-scatter "
                f"({ex.kind}, {strat.compression.compressor}) + all-gather "
                f"({mom.compressor}, ef={mom.error_feedback}): "
                f"{ledger.wire_bytes_per_step / 1e6:.3f} MB a round a "
                f"worker, both legs", flush=True)
    # count-exact participation: each round has n participants, billed at
    # what they move (the selected family member under an adaptive plan)
    n_part = (n_participants(strat.participation.fraction, W)
              if W > 1 and strat.participation.partial else None)
    say(f"# strategy: {strat.describe()} [{strat.short_hash()}]",
          flush=True)
    say(f"# device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)

    # the run sink (repro_torch.obs): every row is one schema event keyed
    # by the strategy's structural identity; the default backend prints
    # the log rows as before. Only rank 0 writes.
    sink = (obs_api.make_sink(args.obs_sink, strategy_hash=strat.short_hash(),
                              tee_stdout=True)
            if rank0 else obs_api.NullSink())
    spans = strat.observability.spans
    # the step profiler (repro_torch.obs.profile): a NullStepProfiler when
    # off; kernels per phase when spans are on
    profiler = obs_api.make_profiler(
        rank0 and (strat.observability.profile or args.profile_steps > 0),
        window=args.profile_steps, trace_dir=args.profile_trace_dir,
        device_phases=spans, device=device)
    sink.emit("run_meta", steps=args.steps, arch=args.arch,
              smoke=bool(args.smoke), n_workers=W, start_step=start,
              strategy_json=strat.to_dict(),
              obs_metrics=strat.observability.metrics)

    # the simulated wall clock (sched.clock): the straggler profile's
    # per-worker compute times around a measured base step, and the
    # modeled exchange of what a round moves
    profile = strat.participation.profile()
    link = sclock.LinkModel()
    t_ex = link.exchange_time(ledger.round_bytes(n_part)[0]) if W > 1 \
        else 0.0
    wall_series = None
    warm = set()    # do_exchange values whose step already ran once

    def batches():
        while True:
            yield {"real": procedural_images(
                args.batch, cfg.image_size, cfg.channels,
                generator=data_gen, device=device)}

    # an encoder-decoder model's batches carry its encoder inputs
    enc_shape = ((cfg.encdec.enc_seq, cfg.d_model)
                 if getattr(cfg, "is_encdec", False) else None)
    it = (batches() if isinstance(cfg, gan.GANConfig)
          else lm_batch_iterator(args.batch, args.seq, cfg.vocab_size,
                                 generator=data_gen, device=device,
                                 enc_shape=enc_shape))
    for _ in range(start):  # keep the data stream aligned across resumes
        next(it)
    history = []
    t0 = time.time()
    interval_s = 0.0       # synced wall time since the last timing event
    interval_n = 0
    for i in range(start, args.steps):
        with obs_api.host_span("data", spans), profiler.phase("data"):
            batch = next(it)
        do_exchange = sched.is_exchange_step(i)
        _sync(device)
        it_t0 = time.perf_counter()
        with obs_api.host_span("step", spans), profiler.phase("step"):
            out = trainer.step(state, batch, do_exchange=do_exchange)
            state = out.state
            _sync(device)
        step_s = time.perf_counter() - it_t0
        profiler.record_step(i, step_s, do_exchange)
        interval_s += step_s
        interval_n += 1
        if wall_series is None and (do_exchange in warm
                                    or i == args.steps - 1):
            # the base compute time from the first step past the set-up
            # of its kind (as the JAX launcher takes it past compilation)
            times = sstrag.step_times(profile, W, args.steps, args.seed,
                                      base=step_s)
            wall_series = sclock.simulate(
                sched, times, t_ex, strat.participation.fraction,
                args.seed)["per_step_s"]
            if i > start:   # backfill the steps already run
                ledger.tick(0, wall_s=float(wall_series[start:i].sum()))
        warm.add(do_exchange)
        wall = float(wall_series[i]) if wall_series is not None else 0.0
        ledger.tick(exchanged=do_exchange, wall_s=wall, participants=n_part)
        if i % args.log_every == 0 or i == args.steps - 1:
            with obs_api.host_span("eval", spans), profiler.phase("eval"):
                m = {k: (float(v) if k != "obs"
                         else {n: x.tolist() for n, x in v.items()})
                     for k, v in out.metrics.items()}
            rec = {"step": i, "round": sched.round_index(i),
                   **({"participants": n_part}
                      if n_part is not None else {}),
                   "loss": m["loss"],
                   "grad_norm": m["grad_norm"],
                   "error_norm": m["error_norm"],
                   **({"staleness_max": m["staleness_max"],
                       "staleness_mean": round(m["staleness_mean"], 2)}
                      if strat.schedule.kind == "delayed" else {}),
                   "wire_mb_step": round(
                       ledger.round_bytes(n_part)[0] / 1e6, 3),
                   "cum_wire_mb": round(ledger.cumulative_wire_bytes / 1e6,
                                        2),
                   "comm_ratio": round(ledger.compression_ratio, 2),
                   "sim_clock_s": round(ledger.sim_clock_s, 3),
                   "step_s": round(step_s, 6),
                   "elapsed_s": round(time.time() - t0, 1)}
            history.append(rec)
            sink.emit("train_log", **rec)
            sink.emit("timing", step=i, step_s=round(step_s, 6),
                      interval_s=round(interval_s, 6),
                      steps_in_interval=interval_n)
            interval_s = 0.0
            interval_n = 0
            if "obs" in m:
                sink.emit("obs_metrics", step=i, **m["obs"])
        if (args.checkpoint and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0
                and i != args.steps - 1):
            save_ckpt(args.checkpoint, state)
    profiler.emit(sink)
    sink.emit("comm_summary", **ledger.summary())
    sink.close()
    if args.checkpoint:
        save_ckpt(args.checkpoint, state)
        say(f"# saved DQState to {args.checkpoint}", flush=True)
    return history


if __name__ == "__main__":
    main()
