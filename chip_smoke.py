#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

  1. build    every CUDA kernel of the port from its source (nvcc, parallel),
              and count each library's tensor-core (HMMA) instructions
              where cuobjdump is present: B4's bfloat16 kernels must have
              some
  2. kernel   hold each kernel against its plain PyTorch version on the
              card, at its path's shapes and at edge cases, and time
              both: B1 (quantize_ef, static levels) at one worker's bucket
              rows, one bucket a launch and the buckets packed back to
              back in one launch (the trainer's; bit-equal; timed both
              ways), B2 (quantize_ef_dyn, levels read from device memory)
              at four workers' stacked bucket rows, B3 (paged decode
              attention) at the serving engine's shapes in bfloat16 and
              float32, with the library call (SDPA on the gathered view)
  3. flash    B4 (causal flash attention), the counterpart of the JAX
              kernel benchmark's attention section: held against its
              plain version at that section's shapes (full and quick
              tier), the JAX kernel test's bfloat16 shape, one gemma-2b
              prefill call (8 heads, 256 tokens, head_dim 256, bfloat16)
              and edge cases, and timed with the library call (SDPA) at
              the full tier (float32) and the gemma-2b call; its launches
              are counted over the timed full-tier run
  3b. ssd     B5 (mamba2's chunked SSD, forward and backward) against its
              plain version at mamba2-1.3b's training shape (2 x 2048, 64
              heads of 64, state 128, chunk 256) in bfloat16 and at the
              reduced config's and T = 35 at chunk 7 in float32: y, the
              final state and the six gradients within the card tests'
              norm-relative gaps, the backward twice bit-equal; forward
              and forward + backward timed with the plain version at the
              training shape. Its launches on each mamba2 path (zoo train,
              serve, long, tp) are counted from zero on that path
  4. train    drive each path of the trainer through its CLI entry point,
              dcgan32 at full width, omd/update, with the launch count of
              every kernel zeroed just before and read just after:
              (a) one worker, batch 64, qsgd8_block1024 over uniform
                  buckets: B1 once a step, over all three buckets;
              (b) four workers stacked on the card, batch 256, half of
                  them reporting each round, adaptive delta_budget at
                  0.75 MiB, sim exchange: B2 three times a step; then 5
                  steps of the same with the two_phase exchange
              (B4 never on either)
  5. serve    drive the serving launcher, gemma-2b at full width in
              bfloat16 (18 layers, d_model 2048, vocab 256,000), 16
              requests of 256 prompt tokens and 64 generated, through the
              engine with --attn-impl kernel: B3 once per layer per decode
              step (63 x 18), B1, B2 and B4 never; then the same with
              --attn-impl gather
  6. parity   trainer steps with the kernels and the same steps with the
              plain quantizer, same draws, compared (one worker; four);
              gemma-2b at full width in float32 served to 6 requests of
              ragged prompts with churn: kernel-path tokens equal to
              gather-path tokens, engine tokens equal to sequential ones
  7. profile  device time by kernel and the device's busy share, for each
              training path and for the engine's decode step (reported)
  8. sched    the trainer's CLI under the schedules, dcgan32 full width:
              one worker under local_k(4) (B1 on the round ends only: 3
              launches in 12 steps) and delayed(2) (B1 at every step, the
              ring's head on the wire: 12 in 12); four workers under
              delayed with the τ-vector (1, 2, 3, 4), half reporting, the
              adaptive family (B2 three times a step); median step times
  9. resume   one worker through B1 under every_step, local_k(4) and
              delayed(2): 5 steps, a checkpoint (.npz; 2 shards), a fresh
              trainer restored from it and 5 more steps, bit-equal to 10
              uninterrupted steps
 10. quality  the paper's comparison on the 2-D mixture (CPOAdam,
              CPOAdam-GQ, DQGAN; 1500 steps each at batch 256), held to
              the ordering the JAX reference shows (PERF.md)
 11. dist     the four-worker path of (b) with its workers on the ranks of
              a torch.distributed group over NCCL (world size 1, four
              workers on the rank; every collective through NCCL) against
              the same workers stacked, in this call: sim 10 steps,
              allgather 5, two_phase 5; rows and states within the port's
              tolerances, B2 three times a step; the NCCL kernels a step
              (profiler) and the median steps of both backends
 12. overlap  exchange.overlap under delayed: one worker delayed(2)
              through B1, four workers with the τ-vector (1, 2, 3, 4)
              through B2, 12 steps each, overlap off then on: the final
              states bit-equal, the exchange kernels on a non-default
              stream (profiler trace); the share of their time under the
              default stream's kernels and the median steps (reported)
 13. obs      the telemetry (repro_torch.obs): one worker through B1 at
              metrics off, wire and full, 10 steps each, twice, bit-equal,
              B1 10 times in each, δ̂ per bucket equal to B1's plain version
              on B1's operands, the kernels a step each level adds, the
              device phases of full adding up to the trace's kernels and
              the field phase holding every kernel launched from
              autograd's backward thread; four workers, τ-vector, half reporting, through B2,
              obs full: δ̂ per bucket against B2's plain version, higher
              at 127 levels than at 7, the staleness histogram summing to 4,
              NCCL at world size 1 equal to stacked; the CLI's sinks
              (profiled run + the delayed(2) overlap pair) read by
              `python -m repro_torch.obs report` and `calibrate`; no
              synchronizing call from core/error_feedback.py (B1's level
              divisor stays on the device)
 14. fsdp     compressed-gradient FSDP through the trainer's CLI, dcgan32
              full width: (a) four workers stacked, batch 256, ZeRO-3,
              two_phase + qsgd8_block1024 moments, 10 steps: B1 once a
              bucket a step on the all-gather leg (3 a step), never on the
              reduce-scatter leg, B2-B4 never; median step, kernels a
              step and busy share; (b) ZeRO-2 under oadam, 5 steps; (c)
              full precision ZeRO-2/3 against replicated exact DDP (rtol
              1e-5, atol 1e-6); (d) (a) over a one-rank NCCL group against
              stacked (the port's tolerances), and the exact reduce-scatter
              through the process group; (e) one worker, B1 on both legs,
              held bit for bit to its plain version on the all-gather
              leg's own operands
 15. quant    quantized weights, gemma-2b full width bf16, 16 requests of
              256 + 64 tokens, qsgd8_linf: the launcher with --weight-plan
              uniform (4 MiB buckets: B1 once a bucket at load, 11; B3
              once a layer a decode step) and delta_budget at 2000 MiB (a
              mix of 8- and 4-bit buckets, B1 once a bucket); B1's load
              held bit for bit to its plain version on the same draws; a
              second engine from the same seed (B1's device time at load
              by CUDA events) with a bit-identical payload and the same
              tokens; decode step time, kernels a step, busy share and
              peak memory, quantized against unquantized
 16. quant parity  gemma-2b full width float32 with 8-bit weights: the
              engine's tokens equal the sequential baseline's (churn)
 17. long     gemma-2b full width float32, a 4096-token prompt bucket, two
              requests: attention_chunked in 4 chunks a layer at prefill,
              engine == sequential, token for token
 18. swa      gemma-2b-swa: reduced() in float32, a 3072-token chunked
              prefill and 40 rolling decode steps held to a full forward;
              full width bf16, an 8192-token prefill (chunks of 1024 x
              5120 keys), the rolling fill, 32 decode steps (times)
 19. lm train LM training through the trainer (run after phase flash):
              starcoder2-7b at its published widths in bf16, 4 of its 32
              layers (1.32 B parameters: the training state must fit
              the card), batch 2 x 2048 tokens, omd, qsgd8_block1024 over
              uniform 4 MiB buckets, 10 steps: B1 once a step over the
              whole packed gradient (~1.29 M rows), finite losses, median
              step, peak memory, a profiled window (busy share, kernels a
              step, B1's device time against its bound), one step's host
              time by function, B1 on one step's packed operands bit-equal
              to its plain version, model FLOPs a step against the bf16
              peak; 3 steps with B1's plain version from the same seed,
              params bit-equal; qwen3-moe-30b-a3b at its widths, 1 of 48
              layers, 5 steps (aux losses, B1 once a step); the CLI at
              starcoder2 reduced, --seq 64 (B1 5 in 5 steps); four stacked
              workers at yi-34b reduced, half reporting, adaptive
              delta_budget 1 MiB (B2 once a bucket a step)
 20. zoo      the SSD and RG-LRU mixers and the encoder-decoder (run after
              phase lm train), at published widths: mamba2-1.3b at all
              48 layers in bf16, batch 2 x 2048, 10 steps (B1 once a step
              over ~1.41 M rows, finite losses and gradients, median step,
              peak memory, a profiled window, B1 on a step's packed
              operands bit-equal to its plain version, 3 steps kernel ==
              plain bit for bit); recurrentgemma-2b at 2 of 26 layers,
              batch 1 x 2048, and whisper-tiny whole, batch 16 x 448 with
              1500 encoder frames (B1 once a step); mamba2 served at 48
              layers through the launcher (bf16, the serve traffic;
              decode kernels and busy share) and in f32 with churn
              (engine == sequential); prefill + decode == one forward in
              f32 at 4096-token prompts (mamba2 4 layers, recurrentgemma 5
              layers) and for whisper (batch 4, 32 steps);
              recurrentgemma-2b at 26 layers in bf16, a 4096-token prefill
              and 32 decode steps (timed); the CLI on each of the three
              archs (B1 5 in 5 steps) and four stacked workers on mamba2
              reduced (B2 once a bucket a step); B5 on each mamba2 path:
              2 forwards and 1 backward a layer a training step, forwards
              only when serving
 21. dryrun   the launch tooling on the meta device (run after phases lm
              train and zoo): all 44 single-mesh (arch x shape) combos of
              `python -m repro_torch.launch.dryrun` at published widths
              over 8 processes (no error, skip exactly at long_500k of the
              8 pure full-attention archs, no device memory used); the
              two LM steps of phases lm train and zoo traced on the meta
              device: the forecast peak within 0.85-1.15 of the peak they
              measured, traced FLOPs at least the model FLOPs, B1 once a
              step; the steps' model-FLOPs share of the bf16 peak
              (reported); each prefill and decode combo traced on a
              rank's shards at model 16 under the reference's layout
              (fsdp above 10 B parameters, one worker), its parameter and
              cache bytes the JAX layout's; the phase under 120 s
 22. tp       the trainer's tensor-parallel 'model' axis (run after phase
              dryrun): NCCL with two ranks on the one card (expected
              refused; the ranks then take gloo over CUDA tensors);
              gemma-2b at its published widths, 4 of 18 layers, batch 2 x
              2048, one process (peak memory), then two spawned ranks of a
              data 1 x model 2 mesh on the card, 5 steps, and on the same
              ranks mamba2-1.3b (48 layers, batch 2 x 2048),
              recurrentgemma-2b (2 layers, batch 1 x 2048) and
              whisper-tiny (whole, batch 16 x 448), 3 steps each: each
              rank holds its shards, B1 once a step over the replicated
              leaves' bucket, bit-equal to its plain version on a step's
              operands, the replicated parameters bit-identical on both
              ranks, each rank's peak against the one process's (phase
              zoo's for the three); the dry-run's forecast of a rank's
              peak within 0.85-1.15 of the measured for gemma-2b and
              mamba2-1.3b (reported for the other two), its parameter
              bytes equal to the rank's; then prefill and decode on the
              same ranks (8 rows x 2048 tokens): gemma-2b whole (18
              layers) and mamba2-1.3b (48) in bf16, 32 and 16 greedy
              steps, one process then the ranks, gemma-2b's cache under
              hd_model and seq_model: each rank's cache exactly half the
              one process's, its prefill and decode peaks within
              0.85-1.15 of the dry-run's forecast, token agreement
              reported beside the prefill logits' |diff| and top-two
              gaps; in f32 (gemma-2b at 4 layers, mamba2-1.3b at 48)
              greedy tokens equal at every step and last logits within
              rtol = atol = 1e-4
 23. layout   the reference's fsdp parameter layout (Mode B; run after
              phase tp, on its backend): yi-34b at its published widths,
              1 of 60 layers (1.48 B parameters), one worker on four
              spawned ranks of a data 2 x model 2 Mode-B mesh (each
              holding its shard of every parameter over its data and
              model indices, the field gathering each period's over the
              data ranks), omd, qsgd8_block1024 over uniform 4 MiB
              buckets, batch 2 x 2048; one process at
              the same depth (the same specs, so the same buckets and
              draws) first. (a) bf16, 3 steps: each rank's parameter
              bytes the reference's per-device bytes at that mesh, finite
              losses, B1 once a step over the replicated leaves' bucket
              and bit-equal to its plain version on one more step's
              operands, the replicated parameters bit-identical across
              the ranks, each rank's peak within 0.85-1.15 of the
              dry-run's forecast and its share of the one process's; (b)
              f32, 3 steps, B1 at qsgd4_block1024's 7 levels: each
              rank's shards against the one process's by
              repro_torch.parity's rule, the step-0 loss within rtol
              1e-5; (c) prefill of 8 rows x 2048 (each data rank its 4)
              and 16 greedy decode steps: in bf16 the peaks within
              0.85-1.15 of the forecast and the token share reported, in
              f32 every greedy token equal and the last logits within
              rtol = atol = 1e-4

The line before the last is {"kernels": [...]}, one record per kernel with
its launches on its path, its error against the plain version, its time,
the plain version's, the library call's where one computes the same
function, the least time the card could take (bytes over 3.35 TB/s, or
operations over 67 TFLOP/s for float32 and 989 TFLOP/s for bfloat16
inputs, the H100 SXM data sheet's peaks) and the kernel's share of it
(bound over time). Each timing line also prints the kernel's earlier time
on an H100 80GB HBM3 at 700 W (`WAS_MS`, PERF.md) as "was". The last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import redirect_stdout
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOP_S = 989e12   # H100 SXM, bfloat16 tensor cores, dense
STEPS, BATCH = 10, 64       # the single-worker path
WORKERS, W_STEPS, W_BATCH, N_PART = 4, 20, 256, 2   # the four-worker path
TWO_PHASE_STEPS = 5
W_ARGS = ["--arch", "dcgan32", "--workers", str(WORKERS), "--batch",
          str(W_BATCH), "--optimizer", "omd", "--lr", "1e-4",
          "--compressor", "qsgd8_block1024", "--comm-plan", "delta_budget",
          "--comm-budget-mb", "0.75", "--comm-adaptive",
          "--participation", "0.5", "--log-every", "1", "--device", "cuda"]
# a code flip needs rand within float rounding of the fractional part:
# expected ~1e-7 of elements, allow 1e-5
MAX_MISMATCH = 1e-5
# the serving path: gemma-2b full width, 16 requests of 256 + 64 tokens
S_BATCH, S_PROMPT, S_GEN = 16, 256, 64
S_ARGS = ["--arch", "gemma-2b", "--batch", str(S_BATCH), "--prompt-len",
          str(S_PROMPT), "--gen", str(S_GEN), "--device", "cuda"]


# each timed kernel's earlier time (PERF.md's kernel table; NVIDIA H100
# 80GB HBM3 at 700.00 W), printed beside this run's as "was": B1's three
# per-bucket launches a step before the one-launch step, B2's
# last time, and B3's and B4's times before their cluster-split redesign
WAS_MS = {"quantize_ef": 0.0245, "quantize_ef_dyn": 0.0553,
          "paged_attention bfloat16": 0.1023,
          "paged_attention float32": 0.1249,
          "flash_attention (a) full tier": 0.1456,
          "flash_attention (d) gemma-2b prefill": 0.0601,
          # B5 before its backward summed through slots, with atomics
          "ssd_chunked forward": 0.956,
          "ssd_chunked forward + backward": 3.099}
# B5's (forward, backward) calls on each mamba2 path, filled as the
# phases run (`check_ssd_path`)
SSD_PATHS = {}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def share_and_was(key, ms, bound):
    """`bound share x, was y ms`: the kernel's share of its bound and its
    earlier time (WAS_MS)."""
    return f"bound share {bound / ms:.4f}, was {WAS_MS[key]:.4f} ms"


def time_ms(fn, iters, flush):
    """Mean device time of fn() in ms, by CUDA events, with the L2 cache
    overwritten before each timed call (the trainer finds its bucket
    operands cold: the field computation ran in between). A sleep kernel
    ahead of each call lets the host queue all of fn's launches before the
    device reaches them, so the events see device time, not host gaps."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of device clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.fmean(a.elapsed_time(b) for a, b in pairs)


def workers_strategy(kind="sim"):
    """The four-worker path's strategy (what W_ARGS select)."""
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Strategy)
    return Strategy(
        compression=Compression(compressor="qsgd8_block1024",
                                plan="delta_budget", budget_mb=0.75,
                                adaptive=True),
        exchange=ExchangePlan(kind=kind, worker_axes=("data",)),
        participation=Participation(fraction=0.5))


def single_strategy():
    from repro_torch.strategy import Compression, Strategy
    return Strategy(compression=Compression(compressor="qsgd8_block1024",
                                            plan="uniform"))


def make_trainer(dev, strat, workers, seed, mesh=None):
    """(trainer, initial state, bucket layout, generator) of dcgan32 at
    full width; `mesh` spreads the workers over its ranks."""
    import torch
    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan
    from repro_torch.models import gan
    cfg = get("dcgan32")
    dq = DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4,
                                message="update")
    gen = torch.Generator(device=dev).manual_seed(seed)
    trainer = dqgan.DQGAN(field_fn=gan.gan_field_fn(cfg), dq=dq, device=dev,
                          workers=workers, mesh=mesh)
    params = gan.init(cfg, generator=gen, device=dev)
    return trainer, trainer.init(params), trainer._comm(params)[0], gen


# --------------------------------------------------------------------------- #
def kernel_label(mangled):
    """`name<args>` of a mangled kernel name as ptxas reports it, e.g.
    flash_fwd<__nv_bfloat16, 256> (enough of the Itanium grammar for the
    port's kernels: nested names, type and integer template arguments)."""
    s, name = (mangled[3:] if mangled.startswith("_ZN") else mangled), ""
    while s[:1].isdigit():       # nested names; the last is the kernel's
        n = re.match(r"\d+", s).group()
        name, s = s[len(n):len(n) + int(n)], s[len(n) + int(n):]
    if not s.startswith("I"):
        return name or mangled
    args, s = [], s[1:]
    types = {"f": "float", "i": "int", "j": "unsigned", "b": "bool"}
    while s and s[0] != "E":
        if s[0] == "L":          # a literal: L<type><value>E
            end = s.index("E")
            args.append(s[2:end])
            s = s[end + 1:]
        elif s[0].isdigit():     # a named type
            n = re.match(r"\d+", s).group()
            args.append(s[len(n):len(n) + int(n)])
            s = s[len(n) + int(n):]
        else:
            args.append(types.get(s[0], s[0]))
            s = s[1:]
    return f"{name}<{', '.join(args)}>"


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"# build: {len(logs)} kernel source(s) in {dt:.1f} s")
    check(sorted(logs) == sorted(_build.SOURCES),
          f"built {sorted(logs)}, the sources are {sorted(_build.SOURCES)}")
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Function properties for " in line:
                fn = kernel_label(line.split("Function properties for ")[1]
                                  .strip())
            elif "registers" in line or "spill" in line:
                print(f"#   {name}: {fn}: {line.strip()}")
    tool = cuobjdump()
    if tool is None:
        print("# build: cuobjdump not found; tensor-core instructions not "
              "counted")
        return
    for name in sorted(_build.SOURCES):
        counts = hmma_counts(tool, _build.library_path(name))
        print(f"# build: {name}: {sum(counts.values())} HMMA instructions "
              f"(cuobjdump -sass)")
        for fn, n in sorted(counts.items()):
            if name == "flash_attention":
                print(f"#   {name}: {fn}: {n} HMMA")
        if name == "flash_attention":
            bf16 = {fn: n for fn, n in counts.items() if "bf16" in fn}
            check(bf16 and all(bf16.values()),
                  f"flash_attention's bfloat16 kernels without tensor-core "
                  f"instructions: {bf16}")


def cuobjdump():
    """The CUDA toolkit's cuobjdump, or None where it is absent."""
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def hmma_counts(tool, lib):
    """{kernel label: HMMA instructions in its SASS} of a built library."""
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib} failed: "
          f"{out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            fn = kernel_label(line.split("Function : ")[1].strip())
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def compare_quantize(g, e, r, levels):
    """Kernel vs plain on the same CUDA tensors; `levels` an int (B1) or a
    one-element device tensor (B2). Returns (max |Δe'|, code mismatch
    fraction, list of failed checks)."""
    import torch
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.ref import quantize_ef_ref
    R = g.shape[0]
    ck, sk, ek = Q.quantize_ef_blocked(g, e, r, levels=levels, block_rows=R)
    cp, sp, ep = quantize_ef_ref(g, e, r, levels)
    torch.cuda.synchronize()
    lvl = (levels.reshape(1, 1) if isinstance(levels, torch.Tensor)
           else sk.new_tensor(float(levels)))
    step = sk / lvl
    err = (ek - ep).abs()
    same = ck == cp
    failed = [msg for ok, msg in (
        (torch.equal(sk, sp), "scale not bit-equal"),
        # same arithmetic in the same order: e' bit-equal where codes agree
        (bool((err[same] == 0).all()), "e' differs where the codes agree"),
        # a code flipped at a rounding boundary moves e' by one step s/L
        (bool((err <= step * 1.0001).all()), "e' off by more than s/L"),
        # e' is the residual of the codes the kernel emitted
        (bool(((g + e) - ck.float() * step - ek).abs().max() == 0),
         "kernel e' is not m - q*s/L"),
    ) if not ok]
    return err.max().item(), (~same).float().mean().item(), failed


def phase_kernel(dev, bucket_rows, levels_row, dyn):
    """Hold B1 (dyn=False: levels a Python int) or B2 (dyn=True: levels a
    device tensor) against its plain version at `bucket_rows` × 1024 with
    each of {127, 7, 1} levels and at the edge cases; time one step's
    launches, one per bucket at `levels_row`. Returns the kernel record."""
    import torch
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.ref import quantize_ef_ref
    gen = torch.Generator(device=dev).manual_seed(3 if dyn else 0)
    name = "quantize_ef_dyn" if dyn else "quantize_ef"

    def lv(L):
        return torch.full((1,), float(L), device=dev) if dyn else L

    def operands(R, C):
        g = 0.3 * torch.randn((R, C), generator=gen, device=dev)
        e = 0.05 * torch.randn((R, C), generator=gen, device=dev)
        r = torch.rand((R, C), generator=gen, device=dev)
        return g, e, r

    # (label, R, C, levels, edit): the path's bucket rows, then edges
    cases = [("bucket", R, 1024, L, None) for R in sorted(set(bucket_rows))
             for L in sorted(set(levels_row) | {127, 7, 1}, reverse=True)]
    cases += [
        ("zero row", 8, 1024, 127, "zero"),
        ("one huge value", 8, 1024, 127, "huge"),
        ("R not a multiple of 256", 37, 1024, 127, None),
        ("one row", 1, 1024, 127, None),
        ("levels", 256, 1024, 7, None),
        ("levels", 256, 1024, 1, None),
        ("narrow rows", 64, 128, 127, None),
        ("wide rows", 64, 4096, 127, None),
        ("rows past the register cache", 16, 12288, 127, None),
    ]
    worst, bad = 0.0, []
    for label, R, C, L, edit in cases:
        g, e, r = operands(R, C)
        if edit == "zero":
            g[3].zero_()
            e[3].zero_()
        elif edit == "huge":
            g[5, 17] = 3.0e20
        err, mism, failed = compare_quantize(g, e, r, lv(L))
        if mism > MAX_MISMATCH:
            failed.append(f"code mismatch {mism:.2e} > {MAX_MISMATCH:.0e}")
        if label == "bucket":
            worst = max(worst, err)
        print(f"# kernel {name} [{label}] R={R} C={C} L={L}: "
              f"max|de'|={err:.3e} "
              f"code mismatch={mism:.2e}"
              + (f" FAILED: {'; '.join(failed)}" if failed else ""))
        bad += [f"{label}: {f}" for f in failed]
    check(not bad, f"{name} disagrees with its plain version: "
          + "; ".join(bad))
    if not dyn:
        worst = check_packed(operands, bucket_rows)

    # time one step's work as the trainer issues it: B1 one packed launch
    # over all of the buckets, B2 one launch a bucket
    ops = [operands(R, 1024) + (lv(L),)
           for R, L in zip(bucket_rows, levels_row)]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def run_buckets():
        for g, e, r, L in ops:
            Q.quantize_ef_blocked(g, e, r, levels=L, block_rows=g.shape[0])

    def run_plain_buckets():
        for g, e, r, L in ops:
            quantize_ef_ref(g, e, r, L)

    if dyn:
        run_kernel, run_plain, n_launch = run_buckets, run_plain_buckets, \
            len(ops)
    else:
        check(len(set(levels_row)) == 1, f"B1's buckets at levels "
              f"{levels_row}: one launch over them needs one level count")
        L1 = levels_row[0]
        packed = [torch.cat([o[i].reshape(-1) for o in ops])
                  for i in range(3)]
        n_launch = 1

        def run_kernel():
            Q.quantize_ef_flat(*packed, levels=L1)

        def run_plain():
            quantize_ef_ref(*(x.reshape(-1, 1024) for x in packed), L1)

    ms = time_ms(run_kernel, 50, flush)
    plain_ms = time_ms(run_plain, 50, flush)
    if not dyn:
        # the same rows in one launch a bucket (what the trainer issued
        # before it packed its buckets): the launches' share of the time
        print(f"# kernel {name} timing, one launch a bucket, {len(ops)} "
              f"launches: {time_ms(run_buckets, 50, flush):.4f} ms")
    n = sum(R * 1024 for R in bucket_rows)
    rows = sum(bucket_rows)
    # g, e, rand read; codes, e' written; a scale per row; B2 also reads
    # its one f32 level count per launch
    nbytes = n * (4 + 4 + 4 + 1 + 4) + rows * 4 + (4 * len(ops) if dyn else 0)
    flops = 11 * n  # add, abs, max, div, mul, floor, sub, cmp, add, mul, sub
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    bound = max(t_bytes, t_ops)
    print(f"# kernel {name} timing, {n_launch} launch(es) "
          f"(rows {list(bucket_rows)}, levels {list(levels_row)}, {n} "
          f"elements, {nbytes / 1e6:.2f} MB): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms, "
          f"{share_and_was(name, ms, bound)}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/quantize_ef.cu",
            "replaces": ("src/repro/kernels/quantize.py:51" if dyn
                         else "src/repro/kernels/quantize.py:42"),
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bound_share": bound / ms}


def check_packed(operands, bucket_rows):
    """Hold B1 over comm buckets packed back to back, one launch (the
    trainer's), bit-equal to the plain version: codes,
    scale and e' to the last bit, at the trainer's bucket rows packed
    together at 127, 7 and 1 levels and at edge cases, row counts that do
    not fill a block's 8 rows among them. Returns the largest |de'| (0)."""
    import torch
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.ref import quantize_ef_ref
    rows = list(bucket_rows)
    cases = [("buckets packed", rows, L, None) for L in (127, 7, 1)]
    cases += [
        ("zero row", [8], 127, "zero"),
        ("one huge value", [8], 127, "huge"),
        ("R not a multiple of 256", [37], 127, None),
        ("one row", [1], 127, None),
        ("rows not filling a block of 8", [13, 6], 127, None),
        ("buckets and 3 rows", rows + [3], 7, None),
    ]
    worst, bad = 0.0, []
    for label, parts, L, edit in cases:
        R = sum(parts)
        g, e, r = operands(R, 1024)
        if edit == "zero":
            g[3].zero_()
            e[3].zero_()
        elif edit == "huge":
            g[5, 17] = 3.0e20
        ck, sk, ek = Q.quantize_ef_flat(g.reshape(-1), e.reshape(-1),
                                        r.reshape(-1), levels=L)
        cp, sp, ep = quantize_ef_ref(g, e, r, L)
        torch.cuda.synchronize()
        err = (ek - ep.reshape(-1)).abs().max().item()
        mism = (ck != cp.reshape(-1)).float().mean().item()
        failed = [msg for ok, msg in (
            (torch.equal(sk, sp.reshape(-1)), "scale not bit-equal"),
            (torch.equal(ck, cp.reshape(-1)), "codes not equal"),
            (torch.equal(ek, ep.reshape(-1)), "e' not bit-equal"),
        ) if not ok]
        worst = max(worst, err)
        print(f"# kernel quantize_ef packed [{label}] rows {parts} (R={R}) "
              f"L={L}: max|de'|={err:.3e} code mismatch={mism:.2e}"
              + (f" FAILED: {'; '.join(failed)}" if failed else ""))
        bad += [f"{label}: {f}" for f in failed]
    check(not bad, "quantize_ef packed disagrees with its plain version: "
          + "; ".join(bad))
    return worst


def check_rows(history, steps):
    check(len(history) == steps, f"{len(history)} log rows for {steps} steps")
    for rec in history:
        for k in ("loss", "grad_norm", "error_norm"):
            check(math.isfinite(rec[k]), f"step {rec['step']}: {k} = {rec[k]}")


def phase_train():
    """Path (a): one worker, B1."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    argv = ["--arch", "dcgan32", "--steps", str(STEPS), "--batch", str(BATCH),
            "--optimizer", "omd", "--lr", "1e-4",
            "--compressor", "qsgd8_block1024", "--comm-plan", "uniform",
            "--log-every", "1", "--device", "cuda"]
    Q.reset_launches()
    FA.reset_launches()
    history = train.main(argv)
    launches, launches_dyn = Q.launches, Q.launches_dyn
    check_rows(history, STEPS)
    check(FA.flash_launches == 0, f"one worker: flash_attention launched "
          f"{FA.flash_launches} times on the training path")
    check(launches == STEPS and launches_dyn == 0,
          f"one worker: quantize_ef launched {launches} times and "
          f"quantize_ef_dyn {launches_dyn} times in {STEPS} steps, expected "
          f"{STEPS} and 0 (one launch a step)")
    step_ms = statistics.median(r["step_s"] for r in history[1:]) * 1e3
    print(f"# train dcgan32 full width, 1 worker, batch {BATCH}: {STEPS} "
          f"steps, quantize_ef launches {launches}, median step "
          f"{step_ms:.3f} ms (first step {history[0]['step_s'] * 1e3:.1f} ms)")
    return launches


def phase_train_workers(dev):
    """Path (b): four stacked workers, half reporting, adaptive family, B2;
    sim for W_STEPS steps, then two_phase for TWO_PHASE_STEPS. Every row
    bills the ledger's round_bytes(N_PART): the selected member's bytes."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    runs = {}
    for kind, steps in (("sim", W_STEPS), ("two_phase", TWO_PHASE_STEPS)):
        tr, st, _, _ = make_trainer(dev, workers_strategy(kind), WORKERS, 0)
        wire_mb = round(tr.comm_ledger(st.params).round_bytes(N_PART)[0]
                        / 1e6, 3)
        del tr, st
        argv = W_ARGS + ["--exchange", kind, "--steps", str(steps)]
        Q.reset_launches()
        FA.reset_launches()
        history = train.main(argv)
        launches, launches_dyn = Q.launches, Q.launches_dyn
        check_rows(history, steps)
        check(FA.flash_launches == 0, f"{WORKERS} workers, {kind}: "
              f"flash_attention launched {FA.flash_launches} times")
        check(launches_dyn == steps * 3 and launches == 0,
              f"{WORKERS} workers, {kind}: quantize_ef_dyn launched "
              f"{launches_dyn} times and quantize_ef {launches} times in "
              f"{steps} steps, expected {steps * 3} and 0")
        for rec in history:
            check(rec.get("participants") == N_PART,
                  f"{kind} step {rec['step']}: participants "
                  f"{rec.get('participants')}, expected {N_PART}")
            check(rec["wire_mb_step"] == wire_mb,
                  f"{kind} step {rec['step']}: wire_mb_step "
                  f"{rec['wire_mb_step']} != the ledger's round_bytes"
                  f"({N_PART}) {wire_mb}")
        step_ms = statistics.median(r["step_s"] for r in history[1:]) * 1e3
        print(f"# train dcgan32 full width, {WORKERS} workers ({N_PART} "
              f"reporting), batch {W_BATCH}, adaptive delta_budget 0.75 MiB, "
              f"{kind}: {steps} steps, quantize_ef_dyn launches "
              f"{launches_dyn}, median step {step_ms:.3f} ms (first step "
              f"{history[0]['step_s'] * 1e3:.1f} ms), wire {wire_mb} MB/step")
        runs[kind] = launches_dyn
    return runs["sim"]


def phase_parity(dev, workers):
    """The same trainer steps with the kernel and with the plain quantizer:
    one worker through B1 (one launch a step), or four through B2
    with two reporting (one launch a bucket)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get
    from repro_torch.core import error_feedback
    from repro_torch.data import procedural_images
    from repro_torch.kernels.ref import quantize_ef_ref

    torch.backends.cudnn.deterministic = True  # same field in both runs
    torch.backends.cudnn.benchmark = False
    cfg = get("dcgan32")
    W = workers
    batch_size = BATCH if W == 1 else W_BATCH
    strat = single_strategy() if W == 1 else workers_strategy()
    trainer, state, layout, gen = make_trainer(dev, strat, W, 1)
    mask = None
    if W > 1:
        mask = torch.zeros((W,), device=dev)
        mask[::W // N_PART] = 1.0
    n = W if mask is None else N_PART
    calls = 1 if W == 1 else len(layout.buckets)
    qsteps = []

    def plain_flat(g, e, rand, *, levels=127):
        m = g.shape[0]
        c, s, en = quantize_ef_ref(g.reshape(-1, 1024), e.reshape(-1, 1024),
                                   rand.reshape(-1, 1024), levels)
        # one quantization step of this launch's largest row scale
        qsteps.append(float(s.max() / (levels.reshape(()) if
                                       isinstance(levels, torch.Tensor)
                                       else float(levels))))
        return c.reshape(m), s.reshape(-1), en.reshape(m)

    results = []
    for _ in range(2):  # a second step so that e_prev is not zero
        batch = {"real": procedural_images(batch_size, 32, 3, generator=gen,
                                           device=dev)}
        draws = {"z": torch.randn((W, batch_size // W, cfg.latent_dim),
                                  generator=gen, device=dev),
                 "rand": {b.bid: torch.rand((W, b.size), generator=gen,
                                            device=dev)
                          for b in layout.buckets}}
        if mask is not None:
            draws["mask"] = mask
        kern = trainer.step(state, batch, draws)
        qsteps.clear()
        with mock.patch.object(error_feedback, "quantize_ef_flat",
                               plain_flat):
            plain = trainer.step(state, batch, draws)
        check(len(qsteps) == calls, f"the plain step quantized "
              f"{len(qsteps)} times, expected {calls}")
        # a code flipped at a rounding boundary moves one worker's p̂ by
        # s/L and the average by s/(L·n)
        qstep = max(qsteps) / n
        pk, pp = T.leaves(kern.state.params), T.leaves(plain.state.params)
        ek, ep = T.leaves(kern.state.ef["leaf"]), T.leaves(
            plain.state.ef["leaf"])
        d_par = max((a - b).abs().max().item() for a, b in zip(pk, pp))
        n_diff = sum(int((a != b).sum()) for a, b in zip(pk, pp))
        n_all = sum(a.numel() for a in pk)
        # p̂ + e' = m for a participant and a sitting worker's e1 is the
        # same in both runs, so params − (1/n)·Σ_w e1_w cancels a flip
        d_inv = max(((a - x.sum(0) / n) - (b - y.sum(0) / n)).abs().max()
                    .item() for a, b, x, y in zip(pk, pp, ek, ep))
        results.append((d_par, d_inv, qstep, n_diff / n_all))
        state = kern.state
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    for i, (d_par, d_inv, qstep, frac) in enumerate(results):
        # params within one quantization step (a code flipped at a rounding
        # boundary) on at most 1e-5 of the elements; params − (1/n)·Σ e1 to
        # float32 rounding of the parameters (|w| < 1)
        check(d_par <= qstep * 1.001, f"{W} worker(s), step {i}: params "
              f"differ by {d_par:.3e} > one quantization step {qstep:.3e}")
        check(frac <= 1e-5, f"{W} worker(s), step {i}: {frac:.2e} of the "
              f"params differ")
        check(d_inv <= 1e-6, f"{W} worker(s), step {i}: params - e1 differ "
              f"by {d_inv:.3e}")
        print(f"# parity kernel vs plain, {W} worker(s), trainer step {i}: "
              f"max|dparams|={d_par:.3e} (quantization step {qstep:.3e}), "
              f"params differing {frac:.2e}, max|d(params - e1/n)|="
              f"{d_inv:.3e}")


def phase_profile(dev, workers, steps=10):
    """Where the trainer's step time goes: torch.profiler over a window of
    steps, device time by kernel and the device's busy share. Reported,
    not checked (the profiler's device tracing is not relied on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import procedural_images

    W = workers
    batch_size = BATCH if W == 1 else W_BATCH
    strat = single_strategy() if W == 1 else workers_strategy()
    trainer, state, _, gen = make_trainer(dev, strat, W, 2)
    batches = [{"real": procedural_images(batch_size, 32, 3, generator=gen,
                                          device=dev)}
               for _ in range(steps + 3)]
    for b in batches[:3]:
        state = trainer.step(state, b).state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            state = trainer.step(state, b).state
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, f"{W} worker(s), batch {batch_size}", steps,
                   wall_ms, "quantize_ef")


def report_profile(prof, label, steps, wall_ms, ours):
    """Print device time by kernel over a profiled window of `steps` steps:
    busy share, kernels a step, the largest ops, and the time of the
    port's kernels whose names contain `ours`."""
    import torch
    kern = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0) or 0
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kern[ev.key] = (kern.get(ev.key, (0, 0))[0] + dt / 1e3,
                            kern.get(ev.key, (0, 0))[1] + ev.count)
    busy_ms = sum(t for t, _ in kern.values())
    if not kern:
        print(f"# profile {label}: the profiler recorded no device time "
              f"(not measured)")
        return None
    print(f"# profile {label}, {steps} steps: wall "
          f"{wall_ms / steps:.3f} ms/step (profiler on), device busy "
          f"{busy_ms / steps:.3f} ms/step, busy share {busy_ms / wall_ms:.3f}, "
          f"{sum(c for _, c in kern.values()) / steps:.0f} kernels/step")
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t, c) in top:
        print(f"#   {t / steps:8.4f} ms/step {c / steps:5.1f}x  {name[:90]}")
    q = sum(t for n, (t, _) in kern.items() if ours in n)
    print(f"#   {ours} kernels: {q / steps:.4f} ms/step "
          f"({q / busy_ms:.3f} of device busy time)")
    return {"wall_ms": wall_ms / steps, "busy_ms": busy_ms / steps,
            "busy_share": busy_ms / wall_ms,
            "kernels": sum(c for _, c in kern.values()) / steps,
            "ours_ms": q / steps}


# --------------------------------------------------------------------------- #
# B3 and the serving path
# --------------------------------------------------------------------------- #
def paged_operands(dev, seed, B, Kh, G, D, bs, maxb, NB, lengths, dtype,
                   parked=()):
    """q and pools random from `seed`; each row's live blocks distinct pool
    blocks (never block 0); rows in `parked` point every table entry at
    block 0, the engine's scratch block, as its inactive slots do."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = (torch.randperm(NB - 1, generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    table = torch.zeros((B, maxb), dtype=torch.int32)
    off = 0
    for b, L in enumerate(lengths):
        nb = -(-L // bs)
        if b not in parked:
            table[b, :nb] = torch.tensor(perm[off:off + nb])
            off += nb
    q, pk, pv = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, Kh, G, D), (NB, bs, Kh, D),
                               (NB, bs, Kh, D)))
    return (q, pk, pv, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of max|x|."""
    m = float(x.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def phase_paged_kernel(dev, scfg, lengths):
    """Hold B3 against its plain version at the engine's shapes (gemma-2b:
    K=1, G=8, D=256; the launcher's ServeConfig: bs 16, `scfg.num_blocks`
    pool blocks, `lengths` ragged up to the run's context) in bfloat16 and
    float32 and at edge cases; time B3, its plain version, and the library
    call (SDPA on the gathered view, the gather apart). Returns the
    kernel record (bfloat16, the serving path's type)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import paged_attention_ref

    B, K, G, D = S_BATCH, 1, 8, 256
    bs, maxb, NB = scfg.block_size, scfg.max_blocks_per_seq, scfg.num_blocks
    ctx = bs * maxb
    sms = FA.sm_count(dev)
    cluster = FA.paged_split(B, K, maxb, sms)
    check(cluster > 1, f"paged_attention: a cluster of {cluster} CTA(s) at "
          f"the serving shape on {sms} SMs")
    cases = [("engine", B, K, G, D, bs, maxb, NB, lengths, ())]
    cases += [("edges: L=0, 1, bs, 2bs, max_context, parked", 8, K, G, D,
               bs, maxb, NB, [0, 1, bs, 2 * bs, ctx, ctx - 7, 1, 5], (6, 7)),
              # the serving shape's cluster: lengths ending on share
              # boundaries, rows with fewer live blocks than CTAs
              ("share boundaries", B, K, G, D, bs, maxb, NB,
               [8 * bs, 16 * bs, 16 * bs - 1, 8 * bs + 1, ctx, 0, 1, 3 * bs,
                7 * bs, 9 * bs, 2 * bs, 4 * bs + 5, 6 * bs, bs, 5, 12 * bs],
               (14,)),
              # a share longer than the blocks a CTA stages at once
              ("chunked shares, MAXB 64", B, K, G, D, bs, 64, B * 64 + 1,
               [64 * bs - 3 * i for i in range(B)], ()),
              # B·K fills the card: a cluster of 1
              ("cluster 1, 160 rows", 160, K, G, 64, bs, 8, 1300,
               [(7 * i) % 128 for i in range(160)], ()),
              # a table longer than the block's threads: not staged
              ("MAXB 300", 3, 1, 2, 16, 4, 300, 2 * 300 + 1, [1200, 577, 0],
               ()),
              ("the JAX test's shape", 3, 2, 2, 16, 4, 5, 12, [1, 7, 20], ()),
              ("D=64", 4, 1, 4, 64, bs, 8, 40, [9, 64, 128, 50], ()),
              ("D=128, bs=32", 3, 2, 8, 128, 32, 4, 16, [100, 128, 5], ())]
    bad, worst = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, *shape, lens, parked) in enumerate(cases):
            ops = paged_operands(dev, 10 + i, *shape, lens, dtype, parked)
            got = FA.paged_flash_attention(*ops)
            want = paged_attention_ref(*ops)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = 2e-5 if dtype == torch.float32 else bf16_ulp(want.float())
            zeros = all(float(got[b].abs().max()) == 0.0
                        for b, L in enumerate(lens) if L == 0)
            failed = [m for ok, m in ((err <= tol, f"error {err:.3e} > "
                                       f"{tol:.3e}"),
                                      (zeros, "an L = 0 row is not zero"),
                                      (got.dtype == dtype, "output dtype"))
                      if not ok]
            name = str(dtype)[6:]
            if label == "engine":
                worst[dtype] = err
            c = FA.paged_split(shape[0], shape[1], shape[5], sms)
            chunk = FA.paged_chunk(shape[4], shape[3], got.element_size(),
                                   shape[5], c)
            print(f"# kernel paged_attention [{label}] {name} B={shape[0]} "
                  f"K={shape[1]} G={shape[2]} D={shape[3]} bs={shape[4]} "
                  f"MAXB={shape[5]} cluster={c} chunk={chunk} "
                  f"L={min(lens)}..{max(lens)}: max|err|={err:.3e} "
                  f"(tolerance {tol:.3e})"
                  + (f" FAILED: {'; '.join(failed)}" if failed else ""))
            bad += [f"{label} {name}: {f}" for f in failed]
    check(not bad, "paged_attention disagrees with its plain version: "
          + "; ".join(bad))

    # time the engine's call: one layer's B3 launch at the engine's shapes
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        q, pk, pv, table, lens = paged_operands(dev, 10, B, K, G, D, bs, maxb,
                                                NB, lengths, dtype)
        S = maxb * bs
        tl = table.long()
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]

        def gather():
            return (pk[tl].reshape(B, S, K, D).transpose(1, 2),
                    pv[tl].reshape(B, S, K, D).transpose(1, 2))

        kg, vg = gather()
        # SDPA's "heads" are the K kv heads and its query rows the G heads
        lib = F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)
        want = paged_attention_ref(q, pk, pv, table, lens)
        lib_err = float((lib.float() - want.float()).abs().max())
        ms = time_ms(lambda: FA.paged_flash_attention(q, pk, pv, table, lens),
                     100, flush)
        plain_ms = time_ms(lambda: paged_attention_ref(q, pk, pv, table,
                                                       lens), 100, flush)
        gather_ms = time_ms(gather, 100, flush)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask), 100, flush)
        esize = q.element_size()
        live = sum(lengths)
        nbytes = (2 * live * K * D * esize        # live keys and values
                  + 2 * q.numel() * esize         # q read, out written
                  + sum(-(-L // bs) for L in lengths) * 4 + B * 4)
        flops = 4 * G * D * live * K              # q.k and p.v
        peak = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else \
            PEAK_F32_FLOP_S
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / peak * 1e3
        name = str(dtype)[6:]
        bound = max(t_bytes, t_ops)
        print(f"# kernel paged_attention timing {name}, one launch (B={B}, "
              f"K={K}, G={G}, D={D}, bs={bs}, L={min(lengths)}..{max(lengths)}"
              f", cluster {cluster}, {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e6:.1f} MFLOP): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library: gather {gather_ms:.4f} ms + SDPA "
              f"{sdpa_ms:.4f} ms (SDPA max|err| {lib_err:.3e}), bound "
              f"{bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}"
              f"), {share_and_was(f'paged_attention {name}', ms, bound)}")
        if dtype == torch.bfloat16:
            rec = {"name": "paged_attention", "route": "cuda",
                   "source": "src/repro_torch/csrc/paged_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:83",
                   "max_abs_err": worst[dtype], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": sdpa_ms, "bound_share": bound / ms}
    return rec


# --------------------------------------------------------------------------- #
# B4: causal flash attention (the JAX kernel benchmark's attention section)
# --------------------------------------------------------------------------- #
def flash_operands(dev, seed, BH, S, D, dtype, shared_kv=False):
    """q, k, v of (BH, S, D) random from `seed`; with `shared_kv` one K/V
    head repeated to all BH query heads (gemma-2b's MQA prefill)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((BH, S, D), generator=gen, device=dev).to(dtype)
    kv_heads = 1 if shared_kv else BH
    k, v = (torch.randn((kv_heads, S, D), generator=gen, device=dev)
            .to(dtype).expand(BH, S, D).contiguous() for _ in range(2))
    return q, k, v


def flash_bound(BH, S, D, dtype, causal):
    """(least ms, "bytes" or "operations", MB, MFLOP) of one call: q, k, v
    read and out written once; 4·D flops (q·k and p·v) a (row, key) pair
    of the lower triangle (all pairs when not causal)."""
    import torch
    esize = 2 if dtype == torch.bfloat16 else 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * D * pairs * BH
    nbytes = 4 * BH * S * D * esize
    peak = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes / 1e6, flops / 1e6)


def phase_flash_kernel(dev):
    """Hold B4 against its plain version at (a) the kernel benchmark's full
    tier (4, 1024, 128) f32, causal and not; (b) its quick tier (4, 256,
    64); (c) the JAX kernel test's (2, 256, 128) bf16; (d) one gemma-2b
    prefill call (8 query heads, the KV head repeated, 256 tokens, D 256,
    bf16); and at edge cases: S = 24 with bq = bk = 8, bq != bk, every
    head dim in both dtypes. Time B4, its plain version and SDPA at (a) and
    (d). Returns the kernel record at (a); its launches are those of the
    timed run of (a), the benchmark's call, counted from zero."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref

    f32, bf16 = torch.float32, torch.bfloat16
    # (label, BH, S, D, dtype, causal, bq, bk, shared_kv)
    cases = [("(a) full tier", 4, 1024, 128, f32, True, 128, 128, False),
             ("(a) full tier", 4, 1024, 128, f32, False, 128, 128, False),
             ("(b) quick tier", 4, 256, 64, f32, True, 128, 128, False),
             ("(c) JAX kernel test", 2, 256, 128, bf16, True, 128, 128,
              False),
             ("(d) gemma-2b prefill", 8, 256, 256, bf16, True, 128, 128,
              True)]
    cases += [("S=24, bq=bk=8", 3, 24, 64, dt, c, 8, 8, False)
              for dt in (f32, bf16) for c in (True, False)]
    cases += [("bq != bk", 4, 256, 128, dt, True, bq, bk, False)
              for dt in (f32, bf16) for bq, bk in ((128, 64), (64, 128))]
    cases += [(f"D={D}", 2, 200, D, dt, c, 8, 8, False)
              for D in FA.HEAD_DIMS for dt in (f32, bf16)
              for c in (True, False)]
    # below one of the kernel's tiles (and one key)
    cases += [(label, BH, S, D, dt, c, b, b, False)
              for label, BH, S, D, b in (("S=8, one partial tile", 2, 8, 64, 8),
                                         ("S=1", 3, 1, 128, 1))
              for dt in (f32, bf16) for c in (True, False)]

    def plain(q, k, v, causal):
        return flash_attention_ref(q[:, :, None], k[:, :, None],
                                   v[:, :, None], causal=causal)[:, :, 0]

    FA.reset_launches()
    bad, worst = [], 0.0
    for i, (label, BH, S, D, dtype, causal, bq, bk, shared) in \
            enumerate(cases):
        q, k, v = flash_operands(dev, 20 + i, BH, S, D, dtype, shared)
        got = FA.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
        want = plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == f32:
            tol = 2e-4
        else:  # one bf16 ulp of the output, and the JAX test's 2e-2
            tol = min(bf16_ulp(want.float()), 2e-2)
        failed = [m for ok, m in ((err <= tol, f"error {err:.3e} > "
                                   f"{tol:.3e}"),
                                  (got.dtype == dtype, "output dtype"),
                                  (bool(torch.isfinite(got).all()),
                                   "non-finite output"))
                  if not ok]
        if label.startswith("(a)") and causal:
            worst = err
        name = str(dtype)[6:]
        tq, tk = FA.flash_tiles(dtype, D)
        c = FA.flash_split(BH, S, tq, tk, FA.sm_count(dev))
        print(f"# kernel flash_attention [{label}] {name} BH={BH} S={S} "
              f"D={D} causal={causal} bq={bq} bk={bk} (tiles {tq}x{tk}, "
              f"cluster {c}): max|err|={err:.3e} "
              f"(tolerance {tol:.3e})"
              + (f" FAILED: {'; '.join(failed)}" if failed else ""))
        bad += [f"{label} {name} D={D} causal={causal}: {f}" for f in failed]
    check(not bad, "flash_attention disagrees with its plain version: "
          + "; ".join(bad))
    check(FA.flash_launches == len(cases) and FA.launches == 0,
          f"flash_attention launched {FA.flash_launches} times for "
          f"{len(cases)} calls (paged_attention {FA.launches})")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    iters, rec = 100, None
    for label, BH, S, D, dtype, shared, seed in (
            ("(a) full tier", 4, 1024, 128, f32, False, 20),
            ("(d) gemma-2b prefill", 8, 256, 256, bf16, True, 24)):
        q, k, v = flash_operands(dev, seed, BH, S, D, dtype, shared)
        lib_err = float((F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True)[0].float()
            - plain(q, k, v, True).float()).abs().max())
        FA.reset_launches()
        ms = time_ms(lambda: FA.flash_attention(q, k, v), iters, flush)
        launches = FA.flash_launches
        check(launches == iters + 3, f"{label}: flash_attention launched "
              f"{launches} times in a timed run of {iters + 3} calls")
        plain_ms = time_ms(lambda: plain(q, k, v, True), iters, flush)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), iters, flush)
        bound, by, mb, mflop = flash_bound(BH, S, D, dtype, True)
        name = str(dtype)[6:]
        tq, tk = FA.flash_tiles(dtype, D)
        c = FA.flash_split(BH, S, tq, tk, FA.sm_count(dev))
        longest = 4 * D * tq * -(-S // c)  # flops of the longest CTA, about
        print(f"# kernel flash_attention timing [{label}] {name}, one causal "
              f"call (BH={BH}, S={S}, D={D}, tiles {tq}x{tk}, cluster {c}, "
              f"{BH * -(-S // tq) * c} CTAs, the longest about "
              f"{longest / 1e6:.1f} MFLOP; {mb:.3f} MB, {mflop:.1f} MFLOP): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library SDPA "
              f"{sdpa_ms:.4f} ms (SDPA max|err| {lib_err:.3e}), bound "
              f"{bound:.5f} ms ({by}), launches {launches}, "
              f"{share_and_was(f'flash_attention {label}', ms, bound)}")
        if rec is None:
            rec = {"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:19",
                   "launches": launches, "max_abs_err": worst, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": sdpa_ms, "bound_share": bound / ms}
    return rec


SSD_CELL = (2, 2048, 64, 64, 128, 256)   # mamba2-1.3b's B, T, H, P, N, chunk
SSD_NAMES = ("y", "h", "dx", "dB", "dC", "ddt", "dA", "dD")


def ssd_operands(dev, seed, B, T, H, P, N, dtype):
    """x, B and C as views of one (B, T, H·P + 2N) tensor (the mixer's
    conv output), dt = softplus(·) float32, A < 0 and D (H,), and the
    cotangents dy and dh, as the card tests draw them."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    di = H * P
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    xbc = f(B, T, di + 2 * N).to(dev, dtype)
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = torch.nn.functional.softplus(f(B, T, H) - 1.0)
    A, D = -torch.exp(f(H) * 0.5), f(H)
    dy, dh = f(B, T, di).to(dev, dtype), f(B, H, P, N)
    return (x, Bm, Cm, dt.to(dev), A.to(dev), D.to(dev), dy,
            dh.to(dev))


def ssd_grads(fn, ops, P, L):
    """y, h and the gradients of <y, dy> + <h, dh> for x, B, C, dt, A, D
    through `fn` (B5's wrapper or its plain version)."""
    import torch
    x, Bm, Cm, dt, A, D, dy, dh = ops
    leaves = [t.detach().requires_grad_() for t in (x, Bm, Cm, dt, A, D)]
    y, h = fn(*leaves, P, L)
    loss = (y.float() * dy.float()).sum() + (h * dh).sum()
    return [y.detach(), h.detach()] + list(torch.autograd.grad(loss, leaves))


def ssd_layers(cfg):
    """The layers of `cfg` that run the SSD (B5 once a layer a forward)."""
    pat = cfg.layer_pattern
    return sum(1 for i in range(cfg.num_layers) if pat[i % len(pat)] == "ssd")


def check_ssd_path(label, counts, layers, steps=None):
    """B5's (forward, backward) calls on one path, counted from zero just
    before it: a training path of `steps` steps makes 2 forwards (the
    field's and its recomputation under remat) and 1 backward a layer a
    step; a serving path (steps None) forwards only, a whole number a
    layer. A model without SSD layers makes none. Kept in SSD_PATHS."""
    fwd, bwd = counts
    if not layers:
        ok, want = fwd == bwd == 0, "0 and 0"
    elif steps is not None:
        ok = (fwd, bwd) == (2 * steps * layers, steps * layers)
        want = f"{2 * steps * layers} and {steps * layers}"
    else:
        ok = fwd > 0 and fwd % layers == 0 and bwd == 0
        want = f"forwards a multiple of {layers} and no backward"
    check(ok, f"{label}: ssd_chunked ran {fwd} forward and {bwd} backward "
          f"calls, expected {want}")
    SSD_PATHS[label] = [fwd, bwd]


def phase_ssd_kernel(dev):
    """Hold B5 against its plain version: at mamba2-1.3b's training shape
    (SSD_CELL) in bfloat16, at the reduced config's (2, 64, 32 heads of 16,
    N 16, chunk 32) and at T = 35 with chunk 7, both in float32: y, the
    final state and the gradients of x, B, C, dt, A and D as norm-relative
    gaps, within the card tests' (float32 2e-4; in bfloat16 5e-3 for the
    bfloat16 outputs, 1e-3 for the float32 ones); each call once more,
    bit-equal. Time the forward and the forward + backward at SSD_CELL with
    the plain version's; the bound is the operations of
    `bench/flops/ssd_chunks.py`'s count at 67 TFLOP/s. Returns B5's record;
    its launches are those of the timed forward + backward run."""
    import torch
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels.ref import ssd_chunked_ref

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("mamba2-1.3b cell", *SSD_CELL, bf16),
             ("reduced config", 2, 64, 32, 16, 16, 32, f32),
             ("T=35 at chunk 7", 2, 35, 4, 16, 16, 7, f32)]
    SSD.reset_launches()
    bad, worst = [], 0.0
    for i, (label, B, T, H, P, N, L, dtype) in enumerate(cases):
        ops = ssd_operands(dev, 50 + i, B, T, H, P, N, dtype)
        got = ssd_grads(SSD.ssd_chunked, ops, P, L)
        again = ssd_grads(SSD.ssd_chunked, ops, P, L)
        want = ssd_grads(ssd_chunked_ref, ops, P, L)
        torch.cuda.synchronize()
        gaps = []
        for name, a, a2, b in zip(SSD_NAMES, got, again, want):
            a64, b64 = a.double(), b.double()
            gap = float((a64 - b64).norm() / b64.norm())
            tol = (2e-4 if dtype == f32 else
                   5e-3 if a.dtype == bf16 else 1e-3)
            gaps.append(f"{name} {gap:.2e}")
            bad += [f"{label} {name}: {m}" for ok, m in (
                (gap <= tol, f"gap {gap:.3e} > {tol:.0e}"),
                (bool(torch.isfinite(a.float()).all()), "not finite"),
                (torch.equal(a, a2), "two calls differ")) if not ok]
            if label == cases[0][0]:
                worst = max(worst, gap)
        print(f"# kernel ssd_chunked [{label}] {str(dtype)[6:]} B={B} T={T} "
              f"H={H} P={P} N={N} L={L}: norm-relative gaps against the "
              f"plain version {', '.join(gaps)}; two calls bit-equal")
        del ops, got, again, want
    check(not bad, "ssd_chunked disagrees with its plain version or with "
          "itself: " + "; ".join(bad))
    check((SSD.ssd_launches, SSD.ssd_bwd_launches)
          == (2 * len(cases), 2 * len(cases)),
          f"ssd_chunked ran {SSD.ssd_launches} forward and "
          f"{SSD.ssd_bwd_launches} backward calls for {2 * len(cases)} of "
          f"each")

    B, T, H, P, N, L = SSD_CELL
    x, Bm, Cm, dt, A, D, dy, dh = ssd_operands(dev, 50, *SSD_CELL[:5], bf16)
    leaves = [t.detach().requires_grad_() for t in (x, Bm, Cm, dt, A, D)]

    def fwd(fn):
        with torch.no_grad():
            return fn(x, Bm, Cm, dt, A, D, P, L)

    def fwd_bwd(fn):
        y, h = fn(*leaves, P, L)
        return torch.autograd.grad((y, h), leaves, (dy, dh))

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    iters = 20
    fwd_ms = time_ms(lambda: fwd(SSD.ssd_chunked), iters, flush)
    plain_fwd_ms = time_ms(lambda: fwd(ssd_chunked_ref), iters, flush)
    SSD.reset_launches()
    ms = time_ms(lambda: fwd_bwd(SSD.ssd_chunked), iters, flush)
    launches = SSD.ssd_launches
    check((launches, SSD.ssd_bwd_launches) == (iters + 3, iters + 3),
          f"ssd_chunked ran {launches} forward and {SSD.ssd_bwd_launches} "
          f"backward calls in a timed run of {iters + 3}")
    plain_ms = time_ms(lambda: fwd_bwd(ssd_chunked_ref), iters, flush)
    # bench/flops/ssd_chunks.py: C·Bᵀ and the masked product over the lower
    # triangle, the chunk states and their read-out; 3x with the backward
    flop = B * T * (L * N + L * H * P + 4.0 * H * P * N)
    fwd_bound, bound = flop / PEAK_F32_FLOP_S * 1e3, 3 * flop / \
        PEAK_F32_FLOP_S * 1e3
    print(f"# kernel ssd_chunked timing [mamba2-1.3b cell] bfloat16 B={B} "
          f"T={T} H={H} P={P} N={N} L={L} ({flop / 1e9:.2f} GFLOP forward, "
          f"{3 * flop / 1e9:.2f} with the backward): forward {fwd_ms:.4f} ms "
          f"(plain {plain_fwd_ms:.4f}, bound {fwd_bound:.4f}, "
          f"{share_and_was('ssd_chunked forward', fwd_ms, fwd_bound)}); "
          f"forward + backward {ms:.4f} ms (plain {plain_ms:.4f}, bound "
          f"{bound:.4f} (operations), launches {launches}, "
          f"{share_and_was('ssd_chunked forward + backward', ms, bound)})")
    return {"name": "ssd_chunked", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunked.cu",
            "replaces": None,   # the JAX package runs the SSD as XLA
            "launches": launches, "max_rel_err": worst, "ms": ms,
            "fwd_ms": fwd_ms, "plain_ms": plain_ms,
            "plain_fwd_ms": plain_fwd_ms, "bound_ms": bound,
            "fwd_bound_ms": fwd_bound, "bound_by": "operations",
            "library_ms": None, "bound_share": bound / ms}


def serve_cli(argv, label):
    """The serving launcher (S_ARGS' traffic) with every kernel's count
    zeroed just before and read just after. Checks the tokens and engine
    steps (prompt 256 is a bucket: the prefill yields token 0, then one
    decode step a further token, all requests in one batch), B3 once a
    layer a step under --attn-impl kernel and never else, B2 and B4
    never. Returns (result, {kernel: launches})."""
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import serve
    FA.reset_launches()
    Q.reset_launches()
    res = serve.main(argv)
    counts = {"quantize_ef": Q.launches, "quantize_ef_dyn": Q.launches_dyn,
              "paged_attention": FA.launches,
              "flash_attention": FA.flash_launches}
    row, steps = res["row"], res["stats"]["steps"]
    layers = get("gemma-2b").num_layers
    check(row["generated"] == S_BATCH * S_GEN and steps == S_GEN - 1,
          f"{label}: {row['generated']} tokens in {steps} engine steps, "
          f"expected {S_BATCH * S_GEN} in {S_GEN - 1}")
    b3 = steps * layers if row["attn_impl"] == "kernel" else 0
    check(counts["paged_attention"] == b3,
          f"{label}: paged_attention launched {counts['paged_attention']} "
          f"times in {steps} steps of {layers} layers, expected {b3}")
    check(counts["quantize_ef_dyn"] == counts["flash_attention"] == 0,
          f"{label}: quantize_ef_dyn, flash_attention launched "
          f"{counts['quantize_ef_dyn']}, {counts['flash_attention']} times")
    return res, counts


def phase_serve():
    """Serve gemma-2b at full width through the launcher, with B3 (kernel)
    and with the gather path; returns B3's launches on the kernel run."""
    import torch
    runs = {}
    for impl in ("kernel", "gather"):
        res, counts = serve_cli(S_ARGS + ["--attn-impl", impl],
                                f"serve {impl}")
        row, steps = res["row"], res["stats"]["steps"]
        b3 = counts["paged_attention"]
        check(counts["quantize_ef"] == 0, f"serve {impl}: quantize_ef "
              f"launched {counts['quantize_ef']} times, expected 0")
        print(f"# serve gemma-2b full width bf16, --attn-impl {impl}: "
              f"{row['generated']} tokens in {steps} engine steps, "
              f"{row['tokens_per_s']} tokens/s, median decode step "
              f"{row['decode_step_s'] * 1e3:.3f} ms, paged_attention "
              f"launches {b3}, sample {row['sample_tokens']}")
        runs[impl] = (b3, res["outputs"])
        del res
        torch.cuda.empty_cache()
    same = sum(a == b for r in runs["kernel"][1]
               for a, b in zip(runs["kernel"][1][r], runs["gather"][1][r]))
    print(f"# serve bf16: kernel and gather paths agree on {same} of "
          f"{S_BATCH * S_GEN} tokens (reported; the float32 parity phase "
          f"checks)")
    return runs["kernel"][0]


def phase_serve_parity(dev):
    """gemma-2b at full width in float32: 6 requests of ragged prompts
    (below every bucket, floor-bucket prefill with a tail, a prompt equal
    to a bucket), 4 slots, requests joining mid-stream; the kernel path
    gives the gather path's greedy tokens, and the engine the sequential
    baseline's."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as lm
    from repro_torch.serve import (Engine, Request, SequentialGenerator,
                                   ServeConfig)

    cfg = dataclasses.replace(get("gemma-2b"), param_dtype="float32")
    params = lm.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        5), device=dev)
    scfg = ServeConfig(max_batch=4, block_size=16, num_blocks=4 * 20 + 2,
                       max_blocks_per_seq=20,
                       prompt_buckets=(16, 32, 64, 128, 256))
    rs = np.random.RandomState(7)
    reqs = [Request(rid=i, prompt=rs.randint(1, cfg.vocab_size, P).tolist(),
                    max_new=G)
            for i, (P, G) in enumerate([(20, 8), (300, 8), (12, 6),
                                        (150, 8), (256, 5), (77, 8)])]

    def churn(impl):
        eng = Engine(cfg, scfg, params, attn_impl=impl)
        for r in reqs[:3]:
            eng.submit(r)
        for r in reqs[3:]:
            eng.step()
            eng.submit(r)
        while not eng.idle:
            eng.step()
        return eng.outputs, eng.steps

    t0 = time.perf_counter()
    FA.reset_launches()
    out_k, steps = churn("kernel")
    b3 = FA.launches
    out_g, _ = churn("gather")
    check(b3 == steps * cfg.num_layers, f"parity: paged_attention launched "
          f"{b3} times in {steps} steps")
    diff = [r.rid for r in reqs if out_k[r.rid] != out_g[r.rid]]
    check(not diff, f"parity f32: kernel and gather paths differ on requests "
          f"{diff}: {[(out_k[i], out_g[i]) for i in diff]}")
    seq = SequentialGenerator(cfg, scfg, params)
    diff = [r.rid for r in reqs
            if seq.generate(list(r.prompt), r.max_new, rid=r.rid)
            != out_g[r.rid]]
    check(not diff, f"parity f32: engine and sequential differ on requests "
          f"{diff}")
    print(f"# parity serve gemma-2b full width f32, TF32 off: 6 requests "
          f"(prompts {[len(r.prompt) for r in reqs]}), 4 slots, churn: "
          f"kernel path == gather path == sequential, token for token "
          f"({sum(len(v) for v in out_g.values())} tokens, {steps} engine "
          f"steps, {b3} paged_attention launches, "
          f"{time.perf_counter() - t0:.1f} s)")
    del params, seq
    torch.cuda.empty_cache()


def phase_serve_profile(dev, steps=10):
    """Where the engine's decode step goes: torch.profiler over 10 steps of
    the serving path (gemma-2b full width bf16, 16 live rows, kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.launch.serve import build_serve_config
    from repro_torch.models import model as lm
    from repro_torch.serve import Engine, Request

    cfg = get("gemma-2b")
    gen = torch.Generator(device=dev).manual_seed(3)
    params = lm.init(cfg, generator=gen, device=dev)
    eng = Engine(cfg, build_serve_config(S_PROMPT, S_GEN, S_BATCH), params,
                 attn_impl="kernel")
    prompts = torch.randint(0, cfg.vocab_size, (S_BATCH, S_PROMPT),
                            generator=gen, device=dev).tolist()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=S_GEN))
    for _ in range(3):        # admission (16 prefills) and warm-up
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, f"serve gemma-2b decode, {S_BATCH} rows", steps,
                   wall_ms, "paged_decode")
    del eng, params
    torch.cuda.empty_cache()

# --------------------------------------------------------------------------- #
# schedules, resume and the paper's quality comparison
# --------------------------------------------------------------------------- #
SCHED_STEPS = 12            # the one-worker schedule runs
LOCAL_K, TAU = 4, 2
TAU_VECTOR = (1, 2, 3, 4)   # the four-worker delayed run, one τ_m a worker
TAU_STEPS = 8
SCHED_ARGS = ["--arch", "dcgan32", "--batch", str(BATCH), "--optimizer",
              "omd", "--lr", "1e-4", "--compressor", "qsgd8_block1024",
              "--comm-plan", "uniform", "--log-every", "1", "--device",
              "cuda"]
TAU_JSON = json.dumps({
    "compression": {"compressor": "qsgd8_block1024", "plan": "delta_budget",
                    "budget_mb": 0.75, "adaptive": True},
    "exchange": {"kind": "sim"},
    "schedule": {"kind": "delayed", "tau": max(TAU_VECTOR),
                 "tau_vector": list(TAU_VECTOR)},
    "participation": {"fraction": 0.5}})
RESUME_STEPS = 10           # 5 + save + restore + 5
QUALITY_STEPS, QUALITY_BATCH = 1500, 256
QUALITY_METHODS = ("CPOAdam", "CPOAdam-GQ", "DQGAN")


def phase_sched(gpu):
    """Drive the trainer's CLI under the schedules, dcgan32 at full width,
    omd/update, qsgd8_block1024, and count the launches each path makes:
    (a) one worker, local_k(4), 12 steps: B1 on the round ends only,
        steps 3, 7 and 11: 3 launches;
    (b) one worker, delayed(2), 12 steps: the wire carries the head of
        the pending ring at EVERY step, as in the reference dataflow (the
        first two heads are zero messages, exchanged all the same): B1
        12 times;
    (c) four workers stacked, batch 256, delayed with τ-vector (1, 2, 3,
        4), half of them reporting, adaptive delta_budget at 0.75 MiB, 8
        steps: B2 once a bucket at every step, 3 × 8 = 24 times, B1 never.
    Rows must carry round, sim_clock_s and, under delayed, the staleness.
    Returns {path: (B1 launches, B2 launches)}."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    runs = [
        ("local_k(4)", SCHED_ARGS + ["--schedule", "local_k", "--local-k",
                                     str(LOCAL_K)],
         SCHED_STEPS, SCHED_STEPS // LOCAL_K, 0, None),
        ("delayed(2)", SCHED_ARGS + ["--schedule", "delayed",
                                     "--staleness-tau", str(TAU)],
         SCHED_STEPS, SCHED_STEPS, 0, float(TAU)),
        (f"delayed tau_vector {TAU_VECTOR}, 4 workers",
         ["--arch", "dcgan32", "--workers", str(WORKERS), "--batch",
          str(W_BATCH), "--optimizer", "omd", "--lr", "1e-4",
          "--strategy-json", TAU_JSON, "--log-every", "1", "--device",
          "cuda"],
         TAU_STEPS, 0, 3 * TAU_STEPS, None),
    ]
    out = {}
    for label, argv, steps, want_b1, want_b2, staleness in runs:
        Q.reset_launches()
        FA.reset_launches()
        history = train.main(argv + ["--steps", str(steps)])
        b1, b2, b4 = Q.launches, Q.launches_dyn, FA.flash_launches
        check_rows(history, steps)
        check(b1 == want_b1 and b2 == want_b2 and b4 == 0,
              f"sched {label}: quantize_ef launched {b1} times, "
              f"quantize_ef_dyn {b2}, flash_attention {b4} in {steps} steps, "
              f"expected {want_b1}, {want_b2} and 0")
        for rec in history:
            check("round" in rec and "sim_clock_s" in rec,
                  f"sched {label} step {rec['step']}: no round/sim_clock_s")
            if staleness is not None:
                check(rec["staleness_max"] == staleness,
                      f"sched {label} step {rec['step']}: staleness_max "
                      f"{rec['staleness_max']}, expected {staleness}")
        step_ms = statistics.median(r["step_s"] for r in history[1:]) * 1e3
        print(f"# sched dcgan32 full width, {label}: {steps} steps, "
              f"quantize_ef launches {b1}, quantize_ef_dyn {b2}, median "
              f"step {step_ms:.3f} ms (first {history[0]['step_s'] * 1e3:.1f}"
              f" ms), rounds {history[-1]['round'] + 1}, sim clock "
              f"{history[-1]['sim_clock_s']} s; gpu {gpu}")
        out[label] = (b1, b2)
    return out


def phase_resume(dev):
    """One worker through B1, dcgan32 full width, in process, under
    every_step, local_k(4) and delayed(2): 10 uninterrupted steps against
    5 steps, a checkpoint (.npz, then a 2-shard directory), a restore
    into a fresh trainer and 5 more. The parameters, EF residuals,
    schedule slots and step must be bit-equal; B1 launches as often as
    the schedule exchanges."""
    import tempfile

    import torch
    from repro_torch import checkpoint as CK
    from repro_torch import tree as T
    from repro_torch.data import procedural_images
    from repro_torch.kernels import quantize as Q
    from repro_torch.strategy import Schedule

    # cuDNN's autotuned algorithms may differ between trainers
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device=dev).manual_seed(11)
    batches = [{"real": procedural_images(BATCH, 32, 3, generator=gen,
                                          device=dev)}
               for _ in range(RESUME_STEPS)]
    half = RESUME_STEPS // 2

    def run(trainer, state, lo, hi):
        sched = trainer.strategy.schedule.runtime()
        for i in range(lo, hi):
            state = trainer.step(state, batches[i],
                                 do_exchange=sched.is_exchange_step(i)).state
        return state

    def named(state):
        return {n: x for n, x in CK._paths(state)}

    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sched in (Schedule.every_step(), Schedule.local_k(LOCAL_K),
                      Schedule.delayed(TAU)):
            strat = single_strategy().evolve(
                schedule=sched.kind, local_k=sched.k,
                staleness_tau=sched.tau)
            rt = strat.schedule.runtime()
            tr, st0, _, _ = make_trainer(dev, strat, 1, 4)
            Q.reset_launches()
            straight = named(run(tr, st0, 0, RESUME_STEPS))
            check(Q.launches == rt.exchanges_in(RESUME_STEPS),
                  f"resume {rt.describe()}: quantize_ef launched "
                  f"{Q.launches} times in {RESUME_STEPS} steps")
            for fmt in ("npz", "sharded"):
                path = os.path.join(tmp, f"{rt.describe()}.{fmt}")
                Q.reset_launches()
                tr1, s, _, _ = make_trainer(dev, strat, 1, 4)
                s = run(tr1, s, 0, half)
                if fmt == "npz":
                    CK.save(path, s, step=s.step,
                            meta={"strategy": strat.to_json()})
                else:
                    CK.save_sharded(path, s, step=s.step, n_shards=2,
                                    meta={"strategy": strat.to_json()})
                del tr1, s
                tr2, like, _, _ = make_trainer(dev, strat, 1, 5)
                CK.verify_strategy(path, strat)
                s = (CK.restore if fmt == "npz" else CK.restore_sharded)(
                    path, like)
                check(s.step == half, f"resume: restored step {s.step}")
                s = named(run(tr2, s, half, RESUME_STEPS))
                launches = Q.launches
                check(launches == rt.exchanges_in(RESUME_STEPS),
                      f"resume {rt.describe()} {fmt}: quantize_ef "
                      f"launched {launches} times")
                check(sorted(s) == sorted(straight),
                      f"resume {rt.describe()} {fmt}: other leaves")
                bad = [n for n in straight
                       if not (torch.equal(s[n], straight[n])
                               if isinstance(s[n], torch.Tensor)
                               else s[n] == straight[n])]
                check(not bad, f"resume {rt.describe()} {fmt}: not "
                      f"bit-equal at {bad[:6]}")
                print(f"# resume dcgan32 full width, 1 worker, "
                      f"{rt.describe()}, {fmt}: {half} + {half} steps == "
                      f"{RESUME_STEPS}, bit for bit over "
                      f"{len(straight)} leaves "
                      f"({sum(x.numel() for x in straight.values() if isinstance(x, torch.Tensor))}"
                      f" elements), quantize_ef launches {launches}")
                total[f"{rt.describe()} {fmt}"] = launches
            del tr, st0, straight
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return total


def phase_quality(gpu):
    """The paper's comparison on the 2-D mixture (`gan_common`): CPOAdam,
    CPOAdam-GQ and DQGAN, 1500 steps each at batch 256, on the card. The
    gate is the ordering the JAX reference shows at 1500 steps on the CPU
    (PERF.md §6: CPOAdam 1/8 modes, fid 37.8061; CPOAdam-GQ 8/8, 6.9386;
    DQGAN 8/8, 0.6591): DQGAN covers at least CPOAdam's modes − 1 with
    an fid within 1.5× of CPOAdam's, and CPOAdam-GQ's fid is worse than
    DQGAN's. The per-leaf qsgd8_linf of these strategies runs no kernel."""
    import torch
    from repro_torch.gan_common import METHOD_STRATEGIES, train_mixture_gan
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    res = {}
    for method in QUALITY_METHODS:
        Q.reset_launches()
        FA.reset_launches()
        t0 = time.perf_counter()
        final, _, st = train_mixture_gan(method, steps=QUALITY_STEPS,
                                         batch=QUALITY_BATCH, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(st.step == QUALITY_STEPS and math.isfinite(final["fid"]),
              f"quality {method}: step {st.step}, fid {final['fid']}")
        check(Q.launches == Q.launches_dyn == FA.flash_launches == 0,
              f"quality {method}: a kernel launched on the per-leaf path")
        print(f"# quality {method:11s} modes {final['modes']}/8 hq_frac "
              f"{final['hq_frac']:.3f} fid {final['fid']:.4f}  "
              f"[{METHOD_STRATEGIES[method].describe()}] {QUALITY_STEPS} "
              f"steps in {secs:.1f} s ({secs / QUALITY_STEPS * 1e3:.3f} "
              f"ms/step); gpu {gpu}")
        res[method] = final
    cpo, gq, dq = (res[m] for m in QUALITY_METHODS)
    check(dq["modes"] >= cpo["modes"] - 1,
          f"quality: DQGAN covers {dq['modes']} modes, CPOAdam "
          f"{cpo['modes']}")
    check(dq["fid"] <= 1.5 * cpo["fid"],
          f"quality: DQGAN fid {dq['fid']} > 1.5 x CPOAdam's {cpo['fid']}")
    check(gq["fid"] > dq["fid"],
          f"quality: CPOAdam-GQ fid {gq['fid']} not worse than DQGAN's "
          f"{dq['fid']}")
    return res


# --------------------------------------------------------------------------- #
# the workers across a process group, and the exchange overlapped
# --------------------------------------------------------------------------- #
DIST_RUNS = (("sim", 10), ("allgather", 5), ("two_phase", 5))
DIST_PROFILE_STEPS = 4
OVERLAP_STEPS = 12
OVERLAP_PROFILE_STEPS = 4


def named_state(state):
    """{name: tensor} of a DQState, in the checkpoint layout's order."""
    from repro_torch import checkpoint as CK
    return dict(CK._paths(state))


def check_states_agree(ref, got, W, n, layout, label):
    """`got` against `ref` (named states of W workers, n reporting a
    round) by the rule the port holds itself to against the JAX package
    (`repro_torch.parity`). Returns (the largest parameter difference,
    that of params - e1/n)."""
    from repro_torch.parity import named_agreement
    agree = named_agreement(ref, got, W, n, layout)
    check(not agree.problems, f"{label}: {'; '.join(agree.problems)}")
    return agree.d_params, agree.d_invariant


def run_steps(trainer, state, batches):
    """(final state, rows, step times in ms): each step ends in a device
    synchronize."""
    import torch
    rows, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.step(state, b)
        state = out.state
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rows.append({k: (float(v) if k != "obs" else
                         {n: x.tolist() for n, x in v.items()})
                     for k, v in out.metrics.items()})
    return state, rows, times


def phase_dist(dev, gpu):
    """The four-worker path (W_ARGS: half reporting, adaptive delta_budget
    at 0.75 MiB, batch 256, dcgan32 full width) with its workers on the
    ranks of a torch.distributed group over NCCL (world size 1: the rank
    holds all four; every collective goes through NCCL), against the same
    workers stacked on the card, in this call: sim 10 steps, allgather 5,
    two_phase 5. Rows and states agree within the port's tolerances; B2
    launches three times a step on both; the NCCL kernels a step come from
    the profiler. Returns {kind: B2 launches over NCCL}."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import procedural_images
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.mesh import ProcessMesh

    torch.backends.cudnn.deterministic = True  # the same field both ways
    torch.backends.cudnn.benchmark = False
    mesh = ProcessMesh.init(0, 1, device_type="cuda", store=dist.HashStore())
    out = {}
    try:
        check(dist.get_backend() == "nccl", f"dist: backend "
              f"{dist.get_backend()}, expected nccl")
        for kind, steps in DIST_RUNS:
            gen = torch.Generator(device=dev).manual_seed(21)
            batches = [{"real": procedural_images(W_BATCH, 32, 3,
                                                  generator=gen, device=dev)}
                       for _ in range(steps)]
            res = {}
            for label, m in (("stacked", None), ("nccl", mesh)):
                tr, st, layout, _ = make_trainer(dev, workers_strategy(kind),
                                                 WORKERS, 3, mesh=m)
                Q.reset_launches()
                FA.reset_launches()
                st, rows, times = run_steps(tr, st, batches)
                launches = (Q.launches, Q.launches_dyn, FA.flash_launches)
                check(launches == (0, 3 * steps, 0),
                      f"dist {kind} {label}: quantize_ef, quantize_ef_dyn, "
                      f"flash_attention launched {launches} times in "
                      f"{steps} steps, expected (0, {3 * steps}, 0)")
                res[label] = (named_state(st), rows, times, launches[1])
                del tr
            (ref, rrows, rtimes, _), (got, grows, gtimes, b2) = (
                res["stacked"], res["nccl"])
            for i, (a, b) in enumerate(zip(rrows, grows)):
                for k in ("loss", "grad_norm", "error_norm"):
                    check(math.isclose(a[k], b[k], rel_tol=1e-5,
                                       abs_tol=1e-7),
                          f"dist {kind} step {i}: {k} {b[k]} over NCCL, "
                          f"{a[k]} stacked")
            d_par, d_inv = check_states_agree(ref, got, WORKERS, N_PART,
                                              layout, f"dist {kind}")
            print(f"# dist dcgan32 full width, {WORKERS} workers ({N_PART} "
                  f"reporting), batch {W_BATCH}, {kind}, {steps} steps: NCCL "
                  f"at world size 1 vs stacked: max|dparams| {d_par:.3e}, "
                  f"max|d(params - e1/n)| {d_inv:.3e}; quantize_ef_dyn "
                  f"launches {b2}; median step stacked "
                  f"{statistics.median(rtimes[1:]):.3f} ms, NCCL "
                  f"{statistics.median(gtimes[1:]):.3f} ms; gpu {gpu}")
            out[kind] = b2
        for kind in ("sim", "two_phase"):
            tr, st, _, gen = make_trainer(dev, workers_strategy(kind),
                                          WORKERS, 4, mesh=mesh)
            batches = [{"real": procedural_images(W_BATCH, 32, 3,
                                                  generator=gen, device=dev)}
                       for _ in range(DIST_PROFILE_STEPS + 2)]
            st, _, _ = run_steps(tr, st, batches[:2])
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_steps(tr, st, batches[2:])
            # NCCL's kernels, the ranges the profiler opens for its calls,
            # and the device copies (a one-rank group may copy instead)
            nccl = {}
            for ev in prof.key_averages():
                key = ev.key.lower()
                if (ev.device_type == torch.autograd.DeviceType.CUDA
                        and ("nccl" in key or key.startswith("memcpy"))):
                    nccl[ev.key] = ev.count / DIST_PROFILE_STEPS
            desc = ", ".join(f"{k[:60]} {v:g}" for k, v in sorted(
                nccl.items())) or "none recorded"
            print(f"# dist {kind}: NCCL events and device copies a step "
                  f"(profiler): {desc}")
            del tr
    finally:
        mesh.close()
        torch.backends.cudnn.deterministic = False
    return out


def trace_kernels(prof):
    """[(name, stream, start_us, end_us)] of every kernel of a profile,
    from its Chrome trace."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [(e["name"], e["args"].get("stream"), e["ts"], e["ts"] + e["dur"])
            for e in events if e.get("cat") == "kernel"]


def overlap_share(kernels, side_streams, default_stream):
    """The share of the side streams' kernel time that overlaps a kernel
    of the default stream."""
    busy = sorted((a, b) for _, s, a, b in kernels if s == default_stream)
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = hidden = 0.0
    for _, s, a, b in kernels:
        if s in side_streams:
            total += b - a
            hidden += sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged
                          if x < b and y > a)
    return hidden / total if total else float("nan"), total


def phase_overlap(dev, gpu):
    """exchange.overlap on the card: (a) one worker, delayed(2), B1 once a
    step, batch 64; (b) four workers stacked, delayed with the τ-vector
    (1, 2, 3, 4), half reporting, the adaptive family, B2 three times a
    step, batch 256; dcgan32 full width, 12 steps each with overlap off,
    then on. The final states must be bit-equal and the exchange kernels
    must run on a stream other than the field's (off, on, on, off: all
    four runs bit-equal). Reported, not claimed:
    the share of the side stream's kernel time that overlaps the default
    stream's, and the median steps. Returns {path: (B1, B2) launches with
    overlap on}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import procedural_images
    from repro_torch.kernels import quantize as Q
    from repro_torch.strategy import Strategy

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = [("1 worker delayed(2)", single_strategy().evolve(
                schedule="delayed", staleness_tau=TAU), 1, BATCH,
             (OVERLAP_STEPS, 0)),
            (f"{WORKERS} workers delayed tau_vector {TAU_VECTOR}",
             Strategy.from_json(TAU_JSON), WORKERS, W_BATCH,
             (0, 3 * OVERLAP_STEPS))]
    out = {}
    try:
        kname = "quantize_ef"     # B1's and B2's kernels
        for label, strat, W, batch, want in runs:
            gen = torch.Generator(device=dev).manual_seed(31)
            batches = [{"real": procedural_images(batch, 32, 3,
                                                  generator=gen, device=dev)}
                       for _ in range(OVERLAP_STEPS)]
            # off, on, on, off: the medians pool both runs of a setting
            res = {False: [], True: []}
            for ov in (False, True, True, False):
                tr, st, _, _ = make_trainer(dev, strat.evolve(overlap=ov), W,
                                            6)
                Q.reset_launches()
                st, _, times = run_steps(tr, st, batches)
                launches = (Q.launches, Q.launches_dyn)
                check(launches == want, f"overlap {label} (overlap={ov}): "
                      f"quantize_ef, quantize_ef_dyn launched {launches} "
                      f"times, expected {want}")
                res[ov].append((named_state(st), times[1:], launches, tr, st))
            off = res[False][0][0]
            for ov, i in ((True, 0), (True, 1), (False, 1)):
                other = res[ov][i][0]
                bad = [k for k in off if not (
                    torch.equal(off[k], other[k])
                    if isinstance(off[k], torch.Tensor)
                    else off[k] == other[k])]
                check(not bad, f"overlap {label}: overlap={ov} run {i} "
                      f"differs from the first off run at {bad[:6]}")
            tr, st = res[True][0][3], res[True][0][4]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_steps(tr, st, batches[:OVERLAP_PROFILE_STEPS])
            kernels = trace_kernels(prof)
            counts = {}
            for _, s, _, _ in kernels:
                counts[s] = counts.get(s, 0) + 1
            ours = {s for n, s, _, _ in kernels if kname in n}
            check(kernels and ours, f"overlap {label}: the profile shows no "
                  f"{kname} kernel")
            default = max((s for s in counts if s not in ours),
                          key=counts.get, default=None)
            check(default is not None, f"overlap {label}: every kernel "
                  f"ran on the exchange's stream {sorted(ours)}")
            share, side_us = overlap_share(kernels, ours, default)
            med = {ov: statistics.median(res[ov][0][1] + res[ov][1][1])
                   for ov in res}
            print(f"# overlap dcgan32 full width, {label}, batch {batch}: "
                  f"{OVERLAP_STEPS} steps, off, on, on, off: bit-equal over "
                  f"{len(off)} leaves; {kname} on stream(s) {sorted(ours)}, "
                  f"the field on stream {default}; side-stream kernels "
                  f"{side_us / OVERLAP_PROFILE_STEPS / 1e3:.4f} ms/step, "
                  f"{share:.3f} of it under default-stream kernels "
                  f"(reported); median step off {med[False]:.3f} ms, on "
                  f"{med[True]:.3f} ms (both runs each); gpu {gpu}")
            out[label] = res[True][0][2]
            del res, tr, st
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out

OBS_STEPS = 10              # phase obs: one worker, each metrics level
OBS_PAIR_STEPS = 12         # the CLI's delayed(2) overlap off/on pair
OBS_PROFILE_STEPS = 2       # steps a kernel count is taken over
OBS_CLI_STEPS, OBS_WINDOW = 10, 8


class QuantizeSpy:
    """Keeps the operands of every `quantize_ef_flat` call (B1's and B2's
    wrapper, as `core.error_feedback` calls it) since the last `take`.
    It keeps them without a copy: each is made for the call (the packed
    or bucketed message, its e, the draw) and nothing writes it after."""

    def __init__(self):
        from repro_torch.core import error_feedback as EF
        self.real, self.calls = EF.quantize_ef_flat, []

    def __call__(self, g, e, rand, *, levels=127):
        self.calls.append((g, e, rand, levels))
        return self.real(g, e, rand, levels=levels)

    def take(self):
        out, self.calls = self.calls, []
        return out


def plain_deltas(calls, bucket_rows=None):
    """[1 − Σe'²/Σm²] of each bucket, e' from B1's/B2's plain version
    (`kernels.ref.quantize_ef_ref`) on the recorded operands: one call a
    bucket (B2), or one call over the buckets packed back to back (B1,
    `bucket_rows` rows each, in order). An empty wire (Σm² = 0, the
    delayed ring's first heads) reads 1, as `obs.finalize` has it."""
    import torch
    from repro_torch.kernels.ref import quantize_ef_ref
    out = []
    for g, e, rand, levels in calls:
        g, e, rand = (x.reshape(-1, 1024) for x in (g, e, rand))
        _, _, e_new = quantize_ef_ref(g, e, rand, levels)
        m = g + e
        splits = bucket_rows or [g.shape[0]]
        for mb, eb in zip(m.split(splits), e_new.split(splits)):
            out.append(1.0 - float(torch.sum(eb * eb))
                       / max(float(torch.sum(mb * mb)), 1e-30))
    return out


def kernels_a_step(tr, st, batches):
    """(state, CUDA kernels a step, the capture) over `batches`, from the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, _, _ = run_steps(tr, st, batches)
    n = len(trace_kernels(prof))
    check(n > 0, "obs: the profiler saw no CUDA kernel")
    return st, n / len(batches), prof


class _Launched:
    """A capture holding its host events and only the device events that
    `ids` (launch correlation ids) made."""

    def __init__(self, prof, ids):
        import torch
        cpu = torch.autograd.DeviceType.CPU
        self._events = [e for e in prof.events()
                        if e.device_type == cpu or e.id in ids]

    def events(self):
        return self._events


def check_phase_costs(prof, kps, steps):
    """The device phases of a captured window (`obs.profile.phase_costs`)
    account for every kernel the trace holds (`kps` a step), and every
    kernel launched from a thread other than the step's (autograd runs
    the field's backward on its own thread) is charged to the field
    phase. Returns ({phase: kernels a step}, the share of the kernels in
    a phase, the backward thread's kernels a step)."""
    import torch
    from repro_torch.obs.profile import phase_costs
    from repro_torch.obs.tracing import PREFIX
    costs = phase_costs(prof, cuda=True)
    per = {k: v["ops"] / steps for k, v in costs.items()}
    check(sum(per.values()) == kps, f"obs: the device phases and the "
          f"kernels outside them ({per}) do not add up to the trace's "
          f"{kps:g} kernels a step")
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    step_threads = {e.thread for e in host if e.name == PREFIX + "field"}
    ids = {e.id for e in host
           if "Launch" in e.name and e.thread not in step_threads}
    other = phase_costs(_Launched(prof, ids), cuda=True) if ids else {}
    check(list(other) == ["field"], f"obs: the kernels launched from "
          f"another thread than the step's ({len(ids)}) are charged to "
          f"{ {k: v['ops'] for k, v in other.items()} }, not all to the "
          f"field phase")
    return (per, 1.0 - per.get(None, 0.0) / kps,
            other["field"]["ops"] / steps)


def syncs_a_step(tr, st, batch):
    """(state, the file:line of each synchronizing CUDA call of one step),
    from PyTorch's sync debug mode (which, by its own warning, does not
    see every synchronizing operation)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st = tr.step(st, batch).state
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return st, [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                for w in caught
                if "called a synchronizing" in str(w.message)]


def phase_obs(dev, gpu):
    """Observability on the card (repro_torch.obs), dcgan32 full width:
    (a) one worker, batch 64, qsgd8_block1024 over uniform buckets, 10
        steps at metrics off, wire and full (spans on for full), twice
        each (off, wire, full with B1's operands kept, then full, wire,
        off as they run, whose medians are reported): every run's state
        bit-equal to the first's, B1 10 launches in each; the
        synchronizing calls of a step at each level (reported);
        delta_hat and bucket_delta each step equal to 1 − Σe'²/Σm² from
        B1's plain version on B1's own operands (atol 1e-6, f32
        rounding); the kernels a step of off, wire and full (profiler);
        full's kernels by device phase (`obs.profile.phase_costs`) add up
        to the trace's, and every kernel launched from a thread other
        than the step's (autograd's backward) is charged to the field
        phase (reported: the share in a phase);
    (b) four workers stacked, batch 256, half reporting, adaptive
        delta_budget 0.75 MiB, delayed with the τ-vector (1, 2, 3, 4),
        obs full, 8 steps: B2 24 launches; bucket_delta per bucket from
        B2's plain version as in (a); bucket_delta higher at 127 levels
        than at 7 once every worker's first message is out (step 4 on);
        staleness_hist sums to 4; the same steps over the
        one-rank NCCL group give the same obs (`parity.obs_agreement`);
    (c) the trainer's CLI: one worker with --obs-metrics full --obs-spans
        --profile-steps 8 and the delayed(2) pair with overlap off then
        on, three sinks in one file; every event validates; `python -m
        repro_torch.obs report --json` has device_phases with ops > 0
        for field, compress and exchange and an overlap row (hidden_s
        reported); calibrate runs on the file.
    Returns {path: (B1 launches, B2 launches)}."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import error_feedback as EF
    from repro_torch.data import procedural_images
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.obs import __main__ as obs_cli
    from repro_torch.obs import read_events
    from repro_torch.parity import obs_agreement
    from repro_torch.strategy import Strategy

    torch.backends.cudnn.deterministic = True   # the same field each run
    torch.backends.cudnn.benchmark = False
    out = {}
    spy = QuantizeSpy()
    try:
        # ---- (a) one worker, B1, off / wire / full -------------------- #
        gen = torch.Generator(device=dev).manual_seed(41)
        batches = [{"real": procedural_images(BATCH, 32, 3, generator=gen,
                                              device=dev)}
                   for _ in range(OBS_STEPS + OBS_PROFILE_STEPS)]
        runs, worst, syncs = {}, 0.0, {}
        # off, wire, full with B1's operands kept for the plain version,
        # then full, wire, off as they run (their medians are reported);
        # every run's state must equal the first's
        for level in ("off", "wire", "full", "full", "wire", "off"):
            strat = single_strategy().evolve(obs_metrics=level,
                                             obs_spans=level == "full")
            tr, st, layout, _ = make_trainer(dev, strat, 1, 7)
            rows_b = [b.size // 1024 for b in layout.buckets]
            Q.reset_launches()
            kept = level != "off" and level not in runs
            with mock.patch.object(EF, "quantize_ef_flat",
                                   spy if kept else spy.real):
                spy.take()
                rows, times = [], []
                for b in batches[:OBS_STEPS]:
                    st, r, t = run_steps(tr, st, [b])
                    rows += r
                    times += t
                    if kept:
                        want = plain_deltas(spy.take(), rows_b)
                        got = r[0]["obs"]["bucket_delta"]
                        check(len(got) == len(want), f"obs {level}: "
                              f"{len(got)} bucket deltas, {len(want)} "
                              f"buckets")
                        d = max(abs(a - b) for a, b in zip(got, want))
                        agg = r[0]["obs"]["delta_hat"]
                        worst = max(worst, d)
                        check(d <= 1e-6, f"obs {level}: bucket_delta "
                              f"{got} vs B1's plain version {want}")
                        check(min(want) - 1e-6 <= agg <= max(want) + 1e-6,
                              f"obs {level}: delta_hat {agg} outside the "
                              f"buckets' {want}")
            b1 = Q.launches
            check((b1, Q.launches_dyn) == (OBS_STEPS, 0),
                  f"obs {level}: quantize_ef launched {b1} times, "
                  f"quantize_ef_dyn {Q.launches_dyn}, in {OBS_STEPS} "
                  f"steps, expected {OBS_STEPS} and 0")
            state = {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in named_state(st).items()}
            kps = None
            if level not in runs:
                st, kps, prof = kernels_a_step(tr, st, batches[OBS_STEPS:])
                if level == "full":
                    phases = check_phase_costs(prof, kps,
                                               OBS_PROFILE_STEPS)
                del prof
                st, syncs[level] = syncs_a_step(tr, st, batches[-1])
                check(not [x for x in syncs[level]
                           if "error_feedback.py" in x],
                      f"obs {level}: synchronizing calls from "
                      f"core/error_feedback.py: {syncs[level]}")
            runs.setdefault(level, []).append((state, rows, times[1:], kps))
            out[f"obs {level}"] = (b1, 0)
            del tr, st
        ref, ref_rows = runs["off"][0][:2]
        for level, rs in runs.items():
            for i, (got, rows, _, _) in enumerate(rs):
                bad = [k for k in ref if not (
                    torch.equal(ref[k], got[k])
                    if isinstance(ref[k], torch.Tensor) else ref[k] == got[k])]
                check(not bad, f"obs {level} run {i}: state differs from "
                      f"the first off run at {bad[:6]}")
                check([{k: v for k, v in r.items() if k != "obs"}
                       for r in rows] == ref_rows,
                      f"obs {level} run {i}: log rows differ from off")
        kps = {lv: rs[0][3] for lv, rs in runs.items()}
        med = {lv: statistics.median(rs[1][2]) for lv, rs in runs.items()}
        last = runs["full"][0][1][-1]["obs"]
        print(f"# obs dcgan32 full width, 1 worker, batch {BATCH}, "
              f"{OBS_STEPS} steps at off / wire / full, twice each: states "
              f"bit-equal ({len(ref)} members); quantize_ef launches "
              f"{OBS_STEPS} in each run; CUDA kernels a step {kps['off']:g} "
              f"/ {kps['wire']:g} / {kps['full']:g} (wire adds "
              f"{kps['wire'] - kps['off']:g}, full "
              f"{kps['full'] - kps['off']:g}); median step (the second "
              f"runs) {med['off']:.3f} / {med['wire']:.3f} / "
              f"{med['full']:.3f} ms; last step delta_hat {last['delta_hat']:.6f}, "
              f"bucket_delta {[round(x, 6) for x in last['bucket_delta']]}; "
              f"max |d| against B1's plain version {worst:.2e}; "
              f"full's kernels a step by device phase "
              + ", ".join(f"{k or 'outside every phase'} {v:g}"
                          for k, v in phases[0].items())
              + f" (share in a phase {phases[1]:.3f}; the field phase holds "
              f"the {phases[2]:g} a step launched from autograd's thread); "
              f"synchronizing calls a step (sync debug mode) "
              + "; ".join(f"{lv} {v}" for lv, v in syncs.items())
              + f"; gpu {gpu}")
        del runs

        # ---- (b) four workers, B2, τ-vector, stacked and NCCL -------- #
        gen = torch.Generator(device=dev).manual_seed(43)
        batches = [{"real": procedural_images(W_BATCH, 32, 3,
                                              generator=gen, device=dev)}
                   for _ in range(TAU_STEPS)]
        strat = Strategy.from_json(TAU_JSON).evolve(obs_metrics="full")
        mesh = ProcessMesh.init(0, 1, device_type="cuda",
                                store=dist.HashStore())
        try:
            res, worst = {}, 0.0
            for label, m in (("stacked", None), ("nccl", mesh)):
                tr, st, layout, _ = make_trainer(dev, strat, WORKERS, 8,
                                                 mesh=m)
                family = tr._family(st.params)
                Q.reset_launches()
                rows = []
                with mock.patch.object(EF, "quantize_ef_flat", spy):
                    spy.take()
                    for b in batches:
                        st, r, _ = run_steps(tr, st, [b])
                        rows += r
                        want = plain_deltas(spy.take())
                        got = r[0]["obs"]["bucket_delta"]
                        d = max(abs(a - b) for a, b in zip(got, want))
                        worst = max(worst, d)
                        check(len(got) == len(want) and d <= 1e-6,
                              f"obs tau_vector {label}: bucket_delta "
                              f"{got} vs B2's plain version {want}")
                check((Q.launches, Q.launches_dyn) == (0, 3 * TAU_STEPS),
                      f"obs tau_vector {label}: quantize_ef, "
                      f"quantize_ef_dyn launched {Q.launches}, "
                      f"{Q.launches_dyn} times, expected 0, "
                      f"{3 * TAU_STEPS}")
                res[label] = rows
                out[f"obs tau_vector {label}"] = (0, Q.launches_dyn)
                del tr, st
            levels = list(family.levels_table()[N_PART - 1])
            for i, r in enumerate(res["stacked"]):
                o = r["obs"]
                hist = o["staleness_hist"]
                check(sum(hist) == WORKERS, f"obs tau_vector step {i}: "
                      f"staleness_hist {hist} does not sum to {WORKERS}")
                if i < max(TAU_VECTOR):
                    continue    # a worker's first messages are not out yet
                hi = [d for d, lv in zip(o["bucket_delta"], levels)
                      if lv == 127]
                lo = [d for d, lv in zip(o["bucket_delta"], levels)
                      if lv == 7]
                check(hi and lo and min(hi) > max(lo),
                      f"obs tau_vector step {i}: bucket_delta "
                      f"{o['bucket_delta']} at levels {levels}: not higher "
                      f"at 127 than at 7")
                problems = obs_agreement(o, res["nccl"][i]["obs"])
                check(not problems, f"obs tau_vector step {i}, NCCL vs "
                      f"stacked: {problems}")
            o = res["stacked"][-1]["obs"]
            print(f"# obs dcgan32 full width, {WORKERS} workers delayed "
                  f"tau_vector {TAU_VECTOR} ({N_PART} reporting), batch "
                  f"{W_BATCH}, full, {TAU_STEPS} steps: quantize_ef_dyn "
                  f"launches {3 * TAU_STEPS} (stacked and NCCL); levels "
                  f"{levels}; last step bucket_delta "
                  f"{[round(x, 6) for x in o['bucket_delta']]}, delta_hat "
                  f"{o['delta_hat']:.6f}, staleness_hist "
                  f"{o['staleness_hist']}; max |d| against B2's plain "
                  f"version {worst:.2e}; NCCL obs within "
                  f"parity.obs_agreement; gpu {gpu}")
        finally:
            mesh.close()
    finally:
        torch.backends.cudnn.deterministic = False

    # ---- (c) the CLI: sinks, report, calibrate ------------------------ #
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--arch", "dcgan32", "--batch", str(BATCH), "--optimizer",
                "omd", "--lr", "1e-4", "--compressor", "qsgd8_block1024",
                "--comm-plan", "uniform", "--device", "cuda"]
        runs = [("profiled", ["--steps", str(OBS_CLI_STEPS), "--obs-metrics",
                              "full", "--obs-spans", "--profile-steps",
                              str(OBS_WINDOW)])]
        runs += [(f"delayed(2) overlap={ov}",
                  ["--steps", str(OBS_PAIR_STEPS), "--schedule", "delayed",
                   "--staleness-tau", str(TAU)]
                  + (["--overlap"] if ov else [])) for ov in (False, True)]
        parts = []
        for i, (label, argv) in enumerate(runs):
            path = os.path.join(tmp, f"run{i}.jsonl")
            Q.reset_launches()
            history = train.main(base + argv + ["--obs-sink", path])
            check_rows(history, int(argv[1]))
            out[f"obs cli {label}"] = (Q.launches, Q.launches_dyn)
            with open(path) as fh:
                parts.append(fh.read())
        sink = os.path.join(tmp, "sink.jsonl")
        with open(sink, "w") as fh:
            fh.write("".join(parts))
        events = read_events(sink)          # validates every event
        rep_path = os.path.join(tmp, "report.json")
        with open(os.devnull, "w") as null, redirect_stdout(null):
            rc = obs_cli.main(["report", sink, "--json", "--out", rep_path])
        check(rc == 0, f"obs report exited {rc}")
        with open(rep_path) as fh:
            rep = json.load(fh)
        dev_ph = rep.get("profile", {}).get("device_phases", {})
        for ph in ("field", "compress", "exchange"):
            check(dev_ph.get(ph, {}).get("ops", 0) > 0,
                  f"obs report: device phase {ph} has no kernel: {dev_ph}")
        check("device_unattributed" in rep.get("profile", {}),
              "obs report: the profile holds no device_unattributed")
        check(len(rep.get("overlap", [])) == 1,
              f"obs report: overlap rows {rep.get('overlap')}")
        cal_path = os.path.join(tmp, "cal.json")
        with open(os.devnull, "w") as null, redirect_stdout(null):
            rc = obs_cli.main(["calibrate", sink, "--json", "--out",
                               cal_path])
        check(rc == 0, f"obs calibrate exited {rc}")
        with open(cal_path) as fh:
            cal = json.load(fh)
        ov = rep["overlap"][0]
        prof = rep["profile"]
        print(f"# obs cli: {len(events)} events valid ("
              f"{', '.join(sorted({e['kind'] for e in events}))}); profile "
              f"window {prof['n_steps']} steps, p50 "
              f"{prof['step_s']['p50'] * 1e3:.3f} ms, device phases "
              + ", ".join(f"{k} {v['ops']} kernels / {v['bytes']} B"
                          for k, v in dev_ph.items())
              + f", outside every phase "
              f"{prof['device_unattributed']['ops']} kernels / "
              f"{prof['device_unattributed']['bytes']} B over "
              f"{prof.get('device_phase_steps')} steps; overlap "
              f"delayed(2): step on {ov['t_on_s'] * 1e3:.3f} ms, off "
              f"{ov['t_off_s'] * 1e3:.3f} ms, hidden_s {ov['hidden_s']}; "
              f"calibrate {cal['method']}, max |drift| "
              f"{cal['max_abs_drift']}; gpu {gpu}")
    return out


FSDP_STEPS = 10             # phase fsdp (a): four workers, ZeRO-3
FSDP_Z2_STEPS = 5           # (b): ZeRO-2 under oadam
FSDP_EQ_STEPS = 5           # (c): full precision against replicated
FSDP_PROFILE_STEPS = 4
FSDP_ARGS = ["--arch", "dcgan32", "--workers", str(WORKERS), "--batch",
             str(W_BATCH), "--lr", "1e-4", "--compressor",
             "qsgd8_block1024", "--moment-compressor", "qsgd8_block1024",
             "--log-every", "1", "--device", "cuda"]


def fsdp_strategy(zero_stage=3, exact=False, workers=WORKERS):
    """A dcgan32 fsdp strategy over uniform buckets: two_phase and
    qsgd8_block1024 on both legs (what FSDP_ARGS select), or exact with
    identity moments (full precision)."""
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      MomentCompression, Strategy)
    comp = "identity" if exact else "qsgd8_block1024"
    return Strategy(
        compression=Compression(compressor=comp, error_feedback=not exact,
                                plan="uniform"),
        exchange=ExchangePlan(kind="exact" if exact else "two_phase",
                              parallelism="fsdp", zero_stage=zero_stage,
                              worker_axes=("data",) if workers > 1 else ()),
        moments=MomentCompression(compressor=comp,
                                  error_feedback=not exact))


def replicated_exact_strategy():
    from repro_torch.strategy import Compression, ExchangePlan, Strategy
    return Strategy(compression=Compression(compressor="identity",
                                            error_feedback=False,
                                            plan="uniform"),
                    exchange=ExchangePlan(kind="exact",
                                          worker_axes=("data",)))


def fsdp_cli(argv, steps, want_b1):
    """The trainer's CLI on `argv`: (log rows, B1 launches), with B2, B3
    and B4 never launched and B1 exactly `want_b1` times."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    Q.reset_launches()
    FA.reset_launches()
    history = train.main(argv)
    launches = (Q.launches, Q.launches_dyn, FA.launches, FA.flash_launches)
    check_rows(history, steps)
    check(launches == (want_b1, 0, 0, 0),
          f"fsdp {argv[-1]}: quantize_ef, quantize_ef_dyn, paged_attention, "
          f"flash_attention launched {launches} times in {steps} steps, "
          f"expected ({want_b1}, 0, 0, 0)")
    return history, launches[0]


def phase_fsdp(dev, gpu):
    """Compressed-gradient FSDP on the card, dcgan32 full width, omd
    unless said, through the trainer's CLI where the other train phases
    use it:
    (a) four workers stacked, batch 256, --preset fsdp_zero3 with
        qsgd8_block1024 on both legs, 10 steps: B1 once a bucket a step on
        the all-gather leg (3 a step: one launch over the four owners'
        (162, 162, 128) rows a bucket; the reduce-scatter leg rounds with
        the registry compressor, no kernel), B2-B4 never; each row billed
        at the ledger's two legs; median step; kernels a step and the
        busy share (profiler); the synchronizing calls of a step (none
        from core/error_feedback.py);
    (b) the same with fsdp_zero2 under oadam, 5 steps (the m, v and dir
        shards on the card): B1 3 a step;
    (c) full precision (exact reduce-scatter, identity moments) zero-2
        and zero-3 against replicated exact DDP, 5 steps: parameters to
        rtol 1e-5, atol 1e-6;
    (d) (a)'s workers on a one-rank NCCL group against stacked in this
        call, within the port's tolerances (`parity.fsdp_agreement`),
        B1 alike; (c)'s zero-3 over NCCL with its reduce-scatter through
        the process group (3 calls a step);
    (e) one worker, batch 64, ZeRO-3 with qsgd8_block1024 on both legs:
        B1 on both legs (6 a step); B1 against its plain version on the
        all-gather leg's own operands (the shard, its residual, the
        draws), bit for bit.
    Returns {path: B1 launches}."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import error_feedback as EF
    from repro_torch.data import procedural_images
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.ref import quantize_ef_ref
    from repro_torch.launch.mesh import ProcessMesh

    out = {}
    # ---- (a) ZeRO-3, four workers, through the CLI --------------------- #
    tr, st, layout, _ = make_trainer(dev, fsdp_strategy(3), WORKERS, 0)
    nb = len(layout.buckets)
    shard_rows = [b.size // WORKERS // 1024 for b in layout.buckets]
    wire_mb = round(tr.comm_ledger(st.params).round_bytes(None)[0] / 1e6, 3)
    del tr, st
    history, b1 = fsdp_cli(FSDP_ARGS + ["--preset", "fsdp_zero3",
                                        "--optimizer", "omd", "--steps",
                                        str(FSDP_STEPS)],
                           FSDP_STEPS, nb * FSDP_STEPS)
    for rec in history:
        check(rec["wire_mb_step"] == wire_mb,
              f"fsdp zero3 step {rec['step']}: wire_mb_step "
              f"{rec['wire_mb_step']} != the ledger's two legs {wire_mb}")
    out["fsdp zero3 4 workers"] = b1
    step_ms = statistics.median(r["step_s"] for r in history[1:]) * 1e3
    print(f"# fsdp dcgan32 full width, {WORKERS} workers, batch {W_BATCH}, "
          f"zero-3, two_phase + qsgd8_block1024 moments: {FSDP_STEPS} "
          f"steps, quantize_ef launches {b1} ({nb} a step, one a bucket "
          f"over {WORKERS} x {shard_rows} rows), median step {step_ms:.3f} "
          f"ms (first step {history[0]['step_s'] * 1e3:.1f} ms), wire "
          f"{wire_mb} MB/step (both legs); gpu {gpu}")
    tr, st, _, gen = make_trainer(dev, fsdp_strategy(3), WORKERS, 2)
    batches = [{"real": procedural_images(W_BATCH, 32, 3, generator=gen,
                                          device=dev)}
               for _ in range(FSDP_PROFILE_STEPS + 3)]
    st, _, _ = run_steps(tr, st, batches[:2])
    st, syncs = syncs_a_step(tr, st, batches[2])
    check(not [x for x in syncs if "error_feedback.py" in x],
          f"fsdp: synchronizing calls from core/error_feedback.py: {syncs}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _, _ = run_steps(tr, st, batches[3:])
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, f"fsdp zero-3 {WORKERS} workers, batch {W_BATCH}",
                   FSDP_PROFILE_STEPS, wall_ms, "quantize_ef")
    print(f"# fsdp zero-3: synchronizing calls a step (sync debug mode) "
          f"{syncs}; gpu {gpu}")
    del tr, st, prof

    # ---- (b) ZeRO-2 under oadam ---------------------------------------- #
    history, b1 = fsdp_cli(FSDP_ARGS + ["--preset", "fsdp_zero2",
                                        "--optimizer", "oadam", "--steps",
                                        str(FSDP_Z2_STEPS)],
                           FSDP_Z2_STEPS, nb * FSDP_Z2_STEPS)
    out["fsdp zero2 oadam"] = b1
    step_ms = statistics.median(r["step_s"] for r in history[1:]) * 1e3
    print(f"# fsdp dcgan32 full width, {WORKERS} workers, zero-2 oadam: "
          f"{FSDP_Z2_STEPS} steps, quantize_ef launches {b1}, median step "
          f"{step_ms:.3f} ms, last loss {history[-1]['loss']:.6f}; gpu {gpu}")

    torch.backends.cudnn.deterministic = True  # the same field each run
    torch.backends.cudnn.benchmark = False
    mesh = ProcessMesh.init(0, 1, device_type="cuda", store=dist.HashStore())
    try:
        gen = torch.Generator(device=dev).manual_seed(23)
        batches = [{"real": procedural_images(W_BATCH, 32, 3,
                                              generator=gen, device=dev)}
                   for _ in range(FSDP_STEPS)]
        # ---- (c) full precision: fsdp ≡ replicated ---------------------- #
        runs = {}
        for label, strat in (("replicated", replicated_exact_strategy()),
                             ("zero2", fsdp_strategy(2, exact=True)),
                             ("zero3", fsdp_strategy(3, exact=True))):
            tr, st, layout, _ = make_trainer(dev, strat, WORKERS, 5)
            st, rows, _ = run_steps(tr, st, batches[:FSDP_EQ_STEPS])
            runs[label] = (named_state(st), rows)
            del tr, st
        worst = 0.0
        ref = runs["replicated"][0]
        for label in ("zero2", "zero3"):
            got = runs[label][0]
            for k in (k for k in ref if k.startswith("params/")):
                d = (got[k] - ref[k]).abs()
                check(bool((d <= 1e-6 + 1e-5 * ref[k].abs()).all()),
                      f"fsdp {label} exact vs replicated: {k} differs by "
                      f"{d.max().item():.3e}")
                worst = max(worst, d.max().item())
        print(f"# fsdp full precision ({WORKERS} workers, exact "
              f"reduce-scatter, identity moments) zero-2 and zero-3 vs "
              f"replicated exact, {FSDP_EQ_STEPS} steps: max|dparams| "
              f"{worst:.3e} (rtol 1e-5, atol 1e-6); gpu {gpu}")

        # ---- (d) over NCCL against stacked ------------------------------ #
        res = {}
        for label, m in (("stacked", None), ("nccl", mesh)):
            tr, st, layout, _ = make_trainer(dev, fsdp_strategy(3), WORKERS,
                                             3, mesh=m)
            Q.reset_launches()
            st, rows, times = run_steps(tr, st, batches)
            res[label] = (named_state(st), rows, times, Q.launches)
            del tr, st
        (ref, rrows, rtimes, rb1), (got, grows, gtimes, gb1) = (
            res["stacked"], res["nccl"])
        check(rb1 == gb1 == nb * FSDP_STEPS and Q.launches_dyn == 0,
              f"fsdp nccl: quantize_ef launched {gb1} (stacked {rb1}), "
              f"expected {nb * FSDP_STEPS}")
        for i, (a, b) in enumerate(zip(rrows, grows)):
            for k in ("loss", "grad_norm", "error_norm"):
                check(math.isclose(a[k], b[k], rel_tol=1e-5, abs_tol=1e-7),
                      f"fsdp nccl step {i}: {k} {b[k]} over NCCL, {a[k]} "
                      f"stacked")
        d_par, d_inv = check_states_agree(ref, got, WORKERS, WORKERS, layout,
                                          "fsdp nccl")
        out["fsdp nccl"] = gb1
        scatter = ("reduce_scatter_single"
                   if hasattr(dist, "reduce_scatter_single")
                   else "reduce_scatter_tensor")
        real = getattr(dist, scatter)
        calls = []

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        with mock.patch.object(dist, scatter, counted):
            tr, st, _, _ = make_trainer(dev, fsdp_strategy(3, exact=True),
                                        WORKERS, 5, mesh=mesh)
            st, _, _ = run_steps(tr, st, batches[:FSDP_EQ_STEPS])
            exact_nccl = named_state(st)
            del tr, st
        check(len(calls) == nb * FSDP_EQ_STEPS,
              f"fsdp nccl exact: dist.{scatter} called {len(calls)} times in "
              f"{FSDP_EQ_STEPS} steps, expected {nb * FSDP_EQ_STEPS}")
        ref = runs["zero3"][0]
        d_exact = max((exact_nccl[k] - ref[k]).abs().max().item()
                      for k in ref if k.startswith("params/"))
        check(all(bool(((exact_nccl[k] - ref[k]).abs()
                        <= 1e-6 + 1e-5 * ref[k].abs()).all())
                  for k in ref if k.startswith("params/")),
              f"fsdp nccl exact vs stacked: params differ by {d_exact:.3e}")
        print(f"# fsdp over NCCL at world size 1 ({WORKERS} workers on the "
              f"rank) vs stacked, zero-3 compressed, {FSDP_STEPS} steps: "
              f"max|dparams| {d_par:.3e}, max|d(w - e1/W)| {d_inv:.3e}; "
              f"quantize_ef launches {gb1}; median step stacked "
              f"{statistics.median(rtimes[1:]):.3f} ms, NCCL "
              f"{statistics.median(gtimes[1:]):.3f} ms; exact zero-3 over "
              f"NCCL: dist.{scatter} {len(calls)} calls in {FSDP_EQ_STEPS} "
              f"steps, max|dparams| vs stacked {d_exact:.3e}; gpu {gpu}")
    finally:
        mesh.close()
        torch.backends.cudnn.deterministic = False

    # ---- (e) one worker: B1 on both legs ------------------------------- #
    tr, st, layout, gen = make_trainer(dev, fsdp_strategy(3, workers=1), 1,
                                       6)
    nb1 = len(layout.buckets)
    batches = [{"real": procedural_images(BATCH, 32, 3, generator=gen,
                                          device=dev)}
               for _ in range(FSDP_EQ_STEPS)]
    spy = QuantizeSpy()
    Q.reset_launches()
    kept, rows = [], []
    with mock.patch.object(EF, "quantize_ef_flat", spy):
        for b in batches:
            st, r, _ = run_steps(tr, st, [b])
            rows += r
            calls = spy.take()
            check(len(calls) == 2 * nb1, f"fsdp 1 worker: {len(calls)} "
                  f"quantize_ef_flat calls a step, expected {2 * nb1}")
            kept += calls[nb1:]     # the all-gather leg's, after the RS's
    check((Q.launches, Q.launches_dyn) == (2 * nb1 * FSDP_EQ_STEPS, 0),
          f"fsdp 1 worker: quantize_ef, quantize_ef_dyn launched "
          f"{Q.launches}, {Q.launches_dyn} times, expected "
          f"{2 * nb1 * FSDP_EQ_STEPS}, 0")
    out["fsdp 1 worker"] = Q.launches
    check_rows([dict(r, step=i) for i, r in enumerate(rows)], FSDP_EQ_STEPS)
    for g, e, rand, levels in kept:
        ck, sk, ek = Q.quantize_ef_flat(g, e, rand, levels=levels)
        cp, sp, ep = quantize_ef_ref(g.reshape(-1, 1024), e.reshape(-1, 1024),
                                     rand.reshape(-1, 1024), levels)
        check(torch.equal(ck, cp.reshape(-1)) and torch.equal(
              sk, sp.reshape(-1)) and torch.equal(ek, ep.reshape(-1)),
              f"fsdp 1 worker: B1 on the all-gather leg's operands "
              f"({g.numel()} elements) differs from its plain version")
    print(f"# fsdp dcgan32 full width, 1 worker, batch {BATCH}, zero-3, "
          f"qsgd8_block1024 on both legs: {FSDP_EQ_STEPS} steps, "
          f"quantize_ef launches {out['fsdp 1 worker']} ({2 * nb1} a step: "
          f"both legs, one a bucket); B1 on the all-gather leg's "
          f"{len(kept)} operand sets bit-equal to its plain version; "
          f"gpu {gpu}")
    return out


# --------------------------------------------------------------------------- #
# quantized weights, long prompts, the sliding-window cache
# --------------------------------------------------------------------------- #
Q_ARGS = S_ARGS + ["--attn-impl", "kernel", "--quantize-weights",
                   "qsgd8_linf"]
# a delta_budget payload target that the planner's descent meets with a mix
# of 8- and 4-bit buckets at gemma-2b (its 8-bit payload models 2890 MiB)
Q_BUDGET_MB = 2000
Q_PLANS = {"uniform": ["--weight-plan", "uniform"],
           "delta_budget": ["--weight-plan", "delta_budget",
                            "--weight-budget-mb", str(Q_BUDGET_MB)]}
Q_SEED = 11
Q_PROFILE_STEPS = 10
LONG_PROMPT, LONG_GEN = 4096, 8      # phase long: two requests
SWA_PROMPT, SWA_DECODE = 8192, 32    # phase swa at full width
SWA_R_PROMPT, SWA_R_DECODE = 3072, 40  # phase swa's f32 gate, reduced()


def gib(nbytes):
    return nbytes / 2**30


def weight_buckets(cfg):
    """The bucket count of `cfg`'s weights at the default 4 MiB buckets
    (shapes only: the params on the meta device)."""
    import torch
    from repro_torch.comm import layout_for_params
    from repro_torch.models import model as lm
    return len(layout_for_params(
        lm.init(cfg, device=torch.device("meta"))).buckets)


def payload_diff(a, b):
    """The buckets of two quantized payloads that differ (by key)."""
    import torch
    return [k for k in a
            if sorted(a[k]) != sorted(b[k])
            or not all(torch.equal(a[k][f], b[k][f]) for f in a[k])]


def run_engine(eng, requests, profile_steps=0, label=""):
    """Drain `requests` through an engine: after 3 steps (admission and
    warm-up) `profile_steps` steps under torch.profiler, the rest timed.
    Returns (outputs, median step ms of the timed steps, profile numbers,
    peak bytes allocated while decoding)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for r in requests:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof_out = None
    if profile_steps:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof_out = report_profile(prof, label, profile_steps, wall_ms,
                                  "quantize_ef")
    times = []
    while not eng.idle:
        t0 = time.perf_counter()
        eng.step()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (dict(eng.outputs), statistics.median(times) if times else None,
            prof_out, peak)


class TimedQuantize:
    """Wraps `quantize_ef_flat` (one B1 launch a call, nothing else on the
    device) with CUDA events: a sleep kernel ahead of each call lets the
    host queue the launch before the device reaches it, as `time_ms`
    does, so the events see B1's device time. (A torch.profiler capture
    of the load dropped the first of the 11 launches.)"""

    def __init__(self, real):
        self.real, self.pairs = real, []

    def __call__(self, *a, **kw):
        import torch
        torch.cuda._sleep(1_000_000)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = self.real(*a, **kw)
        ev[1].record()
        self.pairs.append(ev)
        return out

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def phase_quant(dev, gpu):
    """Quantized weights (the JAX package's serve.quantized_weights), gemma-2b
    full width bf16, 16 requests of 256 + 64 tokens, qsgd8_linf:
    (a) the launcher with --weight-plan uniform (4 MiB buckets): B1 once
        a bucket at load (11), B3 once a layer a decode step, B2 and B4
        never; then engines built here from one seed: B1's load against
        its plain version on the same draws, bucket by bucket, bit for
        bit; a second engine from the same seed (B1's summed device time
        at load, by CUDA events) with a bit-identical payload and the
        same tokens; decode_step_s, kernels a step, busy share and peak memory
        at load and in decode, quantized against unquantized;
    (b) the launcher with --weight-plan delta_budget at Q_BUDGET_MB: at
        least two bit widths, B1 once a non-identity bucket.
    Returns ({path: B1 launches}, {path: B3 launches})."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.serve import build_serve_config
    from repro_torch.models import model as lm
    from repro_torch.serve import Engine, Request
    from repro_torch.serve import quantized_weights as QW
    from repro_torch.strategy import Compression

    cfg = get("gemma-2b")
    nbuckets = weight_buckets(cfg)
    b1, b3 = {}, {}
    # ---- (a), (b) through the launcher ---------------------------------- #
    for plan, flags in Q_PLANS.items():
        res, counts = serve_cli(Q_ARGS + flags, f"quant {plan}")
        row = res["row"]
        bits = sorted({int(m) for m in re.findall(r"(\d+)bx\d+",
                                                  row["weights"])})
        n_id = sum(int(n) for n in re.findall(r"32bx(\d+)", row["weights"]))
        check(counts["quantize_ef"] == nbuckets - n_id,
              f"quant {plan}: quantize_ef launched {counts['quantize_ef']} "
              f"times at load, expected {nbuckets - n_id} (one a bucket "
              f"of {nbuckets}, {n_id} raw)")
        if plan == "delta_budget":
            check(len(set(bits) - {32}) >= 2, f"quant {plan} at "
                  f"{Q_BUDGET_MB} MiB: bits {bits}, expected a mix")
        b1[f"quant {plan} load"] = counts["quantize_ef"]
        b3[f"quant {plan}"] = counts["paged_attention"]
        print(f"# quant gemma-2b full width bf16, {plan}: {row['weights']}; "
              f"load {row['load_s'] * 1e3:.1f} ms, quantize_ef launches "
              f"{counts['quantize_ef']}; {row['generated']} tokens, "
              f"{row['tokens_per_s']} tokens/s, median decode step "
              f"{row['decode_step_s'] * 1e3:.3f} ms, paged_attention "
              f"launches {counts['paged_attention']}, sample "
              f"{row['sample_tokens']}")
        del res
        torch.cuda.empty_cache()

    # ---- (a) engines built here ---------------------------------------- #
    comp = Compression(compressor="qsgd8_linf", plan="uniform")
    scfg = build_serve_config(S_PROMPT, S_GEN, S_BATCH)
    gen = torch.Generator(device=dev).manual_seed(Q_SEED)
    params = lm.init(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    # bytes allocated once loaded (the unquantized engine holds the
    # params); peaks while loading (quantized) and while decoding
    mem = {"unquantized load": torch.cuda.memory_allocated()}
    prompts = torch.randint(0, cfg.vocab_size, (S_BATCH, S_PROMPT),
                            generator=gen, device=dev).tolist()

    def requests():
        return [Request(rid=i, prompt=p, max_new=S_GEN)
                for i, p in enumerate(prompts)]

    eng = Engine(cfg, scfg, params, attn_impl="kernel")
    _, step_u, prof_u, mem["unquantized decode"] = run_engine(
        eng, requests(), Q_PROFILE_STEPS, "quant: unquantized decode, "
        f"{S_BATCH} rows")
    del eng
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    t0 = time.perf_counter()
    eng = Engine(cfg, scfg, params, compression=comp, seed=Q_SEED,
                 attn_impl="kernel")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    mem["quantized load"] = torch.cuda.max_memory_allocated()
    check(Q.launches == nbuckets, f"quant engine: quantize_ef launched "
          f"{Q.launches} times at load, expected {nbuckets}")
    b1["quant engine load"] = Q.launches
    meta, payload = eng.weights.meta, eng.weights.stored
    # B1's plain version on the card, on the same draws
    with mock.patch.object(QW, "quantize_ef_flat", plain_quantize_ef_rows):
        _, plain = QW.quantize_weights(params, comp, seed=Q_SEED)
    bad = payload_diff(payload, plain)
    check(not bad and Q.launches == nbuckets, f"quant: B1's codes or scales "
          f"differ from its plain version's on the same draws in buckets "
          f"{bad}")
    del plain
    torch.cuda.empty_cache()
    # a second engine from the same seed, B1 timed by CUDA events
    timed_b1 = TimedQuantize(QW.quantize_ef_flat)
    with mock.patch.object(QW, "quantize_ef_flat", timed_b1):
        eng2 = Engine(cfg, scfg, params, compression=comp, seed=Q_SEED,
                      attn_impl="kernel")
    b1_ms, b1_n = timed_b1.ms(), len(timed_b1.pairs)
    check(b1_n == nbuckets and Q.launches == 2 * nbuckets,
          f"quant: the second load made {b1_n} quantize_ef_flat calls, "
          f"{Q.launches - nbuckets} launches, expected {nbuckets}")
    bad = payload_diff(payload, eng2.weights.stored)
    check(not bad, f"quant: a second engine from seed {Q_SEED} has another "
          f"payload in buckets {bad}")
    n = sum(b.size for b in meta.layout.buckets)
    rows = n // 1024
    # B1 at load reads g, e, rand and writes codes, e'; a scale a row
    load_bound = (n * 17 + rows * 4) / PEAK_BYTES_S * 1e3
    del params
    out_2, *_ = run_engine(eng2, requests())
    del eng2
    torch.cuda.empty_cache()
    mem["quantized resident"] = torch.cuda.memory_allocated()

    out_q, step_q, prof_q, mem["quantized decode"] = run_engine(
        eng, requests(), Q_PROFILE_STEPS, f"quant: qsgd8_linf decode, "
        f"{S_BATCH} rows")
    check(out_q == out_2, "quant: two engines from one seed decode other "
          "tokens")
    check(all(len(out_q[i]) == S_GEN for i in range(S_BATCH)),
          "quant: a request did not get its tokens")
    print(f"# quant load, {meta.describe()}: wall {load_ms:.1f} ms; B1 "
          f"{b1_n} launches, {b1_ms:.3f} ms of device time (CUDA events), "
          f"share of the bound {load_bound / b1_ms:.3f}, bound "
          f"{load_bound:.3f} ms "
          f"({n * 17 / 1e9:.2f} GB at {PEAK_BYTES_S / 1e12:.2f} TB/s); "
          f"payload bit-equal to B1's plain version on the same draws and "
          f"to a second engine's from seed {Q_SEED}; tokens equal; "
          f"gpu {gpu}")
    for label, step, pr in (("unquantized", step_u, prof_u),
                            ("quantized", step_q, prof_q)):
        extra = (f", {pr['kernels']:.0f} kernels/step, busy "
                 f"{pr['busy_ms']:.3f} ms/step, busy share "
                 f"{pr['busy_share']:.3f}" if pr else ", not profiled")
        print(f"# quant decode {label}: median step {step:.3f} ms (profiler "
              f"off){extra}; peak in decode "
              f"{gib(mem[label + ' decode']):.2f} GiB; gpu {gpu}")
    print(f"# quant memory: unquantized weights {gib(mem['unquantized load']):.2f}"
          f" GiB allocated once loaded; quantized load peak "
          f"{gib(mem['quantized load']):.2f} GiB (the bf16 params, the "
          f"payload so far and one bucket's f32 operands), "
          f"{gib(mem['quantized resident']):.2f} GiB allocated once the "
          f"params are dropped (the payload)")
    del eng, payload
    torch.cuda.empty_cache()
    return b1, b3


def phase_quant_parity(dev):
    """gemma-2b at full width in float32 with 8-bit weights (uniform, 4 MiB
    buckets): 4 requests of ragged prompts, 4 slots, requests joining
    mid-stream; the engine's greedy tokens equal the sequential
    baseline's, both rebuilding the weights at every step."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as lm
    from repro_torch.serve import (Engine, Request, SequentialGenerator,
                                   ServeConfig)
    from repro_torch.strategy import Compression

    cfg = dataclasses.replace(get("gemma-2b"), param_dtype="float32")
    params = lm.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        5), device=dev)
    comp = Compression(compressor="qsgd8_linf", plan="uniform")
    scfg = ServeConfig(max_batch=4, block_size=16, num_blocks=4 * 20 + 2,
                       max_blocks_per_seq=20,
                       prompt_buckets=(16, 32, 64, 128, 256))
    rs = np.random.RandomState(8)
    reqs = [Request(rid=i, prompt=rs.randint(1, cfg.vocab_size, P).tolist(),
                    max_new=G)
            for i, (P, G) in enumerate([(20, 6), (300, 6), (256, 4),
                                        (77, 6)])]
    t0 = time.perf_counter()
    eng = Engine(cfg, scfg, params, compression=comp, seed=Q_SEED,
                 attn_impl="kernel")
    for r in reqs[:2]:
        eng.submit(r)
    for r in reqs[2:]:
        eng.step()
        eng.submit(r)
    while not eng.idle:
        eng.step()
    out, steps = eng.outputs, eng.steps
    del eng
    seq = SequentialGenerator(cfg, scfg, params, compression=comp,
                              seed=Q_SEED)
    del params
    diff = [r.rid for r in reqs
            if seq.generate(list(r.prompt), r.max_new, rid=r.rid)
            != out[r.rid]]
    check(not diff, f"quant parity f32: engine and sequential differ on "
          f"requests {diff}")
    print(f"# quant parity gemma-2b full width f32, 8-bit weights, TF32 "
          f"off: {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), 4 slots, churn: engine == "
          f"sequential, token for token ({sum(map(len, out.values()))} "
          f"tokens, {steps} engine steps, "
          f"{time.perf_counter() - t0:.1f} s)")
    del seq
    torch.cuda.empty_cache()


class ChunkSpy:
    """Counts `attention_chunked` calls and the (query rows, key rows) of
    the `attention_dense` calls made inside them."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.calls, self.chunks = [], []
        self._depth = 0

    def __enter__(self):
        L = self.layers
        real_chunked, real_dense = L.attention_chunked, L.attention_dense

        def chunked(q, k, v, **kw):
            self.calls.append(q.shape[1])
            self._depth += 1
            try:
                return real_chunked(q, k, v, **kw)
            finally:
                self._depth -= 1

        def dense(q, k, *a, **kw):
            if self._depth:
                self.chunks.append((q.shape[1], k.shape[1]))
            return real_dense(q, k, *a, **kw)

        self._patches = [mock.patch.object(L, "attention_chunked", chunked),
                         mock.patch.object(L, "attention_dense", dense)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def phase_long(dev, gpu):
    """A long prompt through the engine: gemma-2b full width in float32
    (TF32 off), a ServeConfig with a 4096-token prompt bucket, two
    requests (4096 tokens, and 4100: the bucket plus a 4-token tail
    through decode), 8 tokens each. Each prefill runs attention_chunked
    in 4 chunks of 1024 queries over all 4096 keys in every layer; the
    engine's tokens equal the sequential baseline's."""
    import dataclasses

    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as lm
    from repro_torch.serve import (Engine, Request, SequentialGenerator,
                                   ServeConfig, cdiv)

    cfg = dataclasses.replace(get("gemma-2b"), param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(13)
    params = lm.init(cfg, generator=gen, device=dev)
    mbps = cdiv(LONG_PROMPT + 4 + LONG_GEN - 1, 16)
    scfg = ServeConfig(max_batch=2, block_size=16, num_blocks=2 * mbps + 2,
                       max_blocks_per_seq=mbps,
                       prompt_buckets=(256, 1024, LONG_PROMPT))
    prompts = torch.randint(0, cfg.vocab_size, (2, LONG_PROMPT + 4),
                            generator=gen, device=dev).tolist()
    reqs = [Request(rid=0, prompt=prompts[0][:LONG_PROMPT], max_new=LONG_GEN),
            Request(rid=1, prompt=prompts[1], max_new=LONG_GEN)]
    t0 = time.perf_counter()
    with ChunkSpy() as spy:
        eng = Engine(cfg, scfg, params)
        out = eng.run(reqs)
        torch.cuda.synchronize()
        t_eng = time.perf_counter() - t0
        seq = SequentialGenerator(cfg, scfg, params)
        got = {r.rid: seq.generate(list(r.prompt), r.max_new, rid=r.rid)
               for r in reqs}
    n_pref = 2 * 2 * cfg.num_layers         # 2 requests, engine + sequential
    check(spy.calls == [LONG_PROMPT] * n_pref
          and spy.chunks == [(1024, LONG_PROMPT)] * (4 * n_pref),
          f"long: attention_chunked calls {spy.calls[:4]}... "
          f"({len(spy.calls)}), chunks {sorted(set(spy.chunks))} "
          f"({len(spy.chunks)}), expected {n_pref} calls of 4 chunks")
    check(got == out and all(len(v) == LONG_GEN for v in out.values()),
          f"long: engine {out} and sequential {got} differ")
    print(f"# long gemma-2b full width f32, prompts {LONG_PROMPT} and "
          f"{LONG_PROMPT + 4} (bucket {LONG_PROMPT}): attention_chunked "
          f"{len(spy.calls)} calls of 4 chunks (1024 queries x "
          f"{LONG_PROMPT} keys); engine == sequential, token for token "
          f"({out}); engine {t_eng:.2f} s; gpu {gpu}")
    del params, eng, seq
    torch.cuda.empty_cache()


def phase_swa(dev, gpu):
    """gemma-2b-swa (gemma-2b with a 4096-token window), the rolling
    sliding-window cache on the dense-cache path (`lm.prefill`,
    `lm.decode_step`; the paged engine refuses windowed models, as the
    JAX package's does):
    (a) reduced() in float32 (window 32): a 3072-token prefill
        (attention_chunked, bands of 2048 keys), the rolling fill of 32
        slots, 40 teacher-forced decode steps that wrap the window; each
        step's logits against a full forward over the sequence (causal:
        position t sees tokens <= t only), to float32 rounding;
    (b) full width in bfloat16: an 8192-token prefill, chunked with bands
        of 5120 keys (8 chunks a layer), the rolling fill of 4096 slots,
        32 decode steps (slots 0..31 written again); times reported,
        logits finite."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as lm

    # ---- (a) the float32 gate ------------------------------------------ #
    cfg = get("gemma-2b-swa").reduced()
    win = cfg.attention_window
    gen = torch.Generator(device=dev).manual_seed(17)
    params = lm.init(cfg, generator=gen, device=dev)
    S = SWA_R_PROMPT + SWA_R_DECODE
    seq = torch.randint(1, cfg.vocab_size, (2, 4096), generator=gen,
                        device=dev)
    hidden, _, _ = lm.forward(params, cfg, seq, torch.arange(4096,
                                                            device=dev))
    ref = lm.logits_fn(params, cfg, hidden)          # (2, 4096, V)
    with ChunkSpy() as spy:
        lg, caches = lm.prefill(params, cfg, seq[:, :SWA_R_PROMPT])
    check(spy.chunks == [(1024, 2048)] * (3 * cfg.num_layers),
          f"swa reduced: chunks {sorted(set(spy.chunks))} "
          f"({len(spy.chunks)}), expected {3 * cfg.num_layers} of "
          f"(1024, 2048)")
    check(caches["scan"]["b0"]["k"].shape[2] == win,
          f"swa reduced: cache of {caches['scan']['b0']['k'].shape[2]} "
          f"slots, expected {win}")
    scale = ref.abs().max().item()
    errs = [(lg - ref[:, SWA_R_PROMPT - 1]).abs().max().item()]
    for t in range(SWA_R_PROMPT, S):
        lg, caches = lm.decode_step(params, cfg, seq[:, t:t + 1], caches)
        errs.append((lg - ref[:, t]).abs().max().item())
    check(max(errs) <= 1e-4 * scale, f"swa reduced f32: rolling decode "
          f"logits off the full forward by {max(errs):.3e} (max |logit| "
          f"{scale:.3e})")
    print(f"# swa gemma-2b-swa reduced() f32 (window {win}): prefill "
          f"{SWA_R_PROMPT} (chunks of 1024 x 2048 keys), {SWA_R_DECODE} "
          f"rolling decode steps: max |logits - full forward| "
          f"{max(errs):.3e} (max |logit| {scale:.3e})")
    del params, caches, ref, hidden

    # ---- (b) full width, bfloat16 -------------------------------------- #
    cfg = get("gemma-2b-swa")
    win = cfg.attention_window
    gen = torch.Generator(device=dev).manual_seed(19)
    params = lm.init(cfg, generator=gen, device=dev)
    seq = torch.randint(1, cfg.vocab_size, (1, SWA_PROMPT + SWA_DECODE),
                        generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ChunkSpy() as spy:
        t0 = time.perf_counter()
        lg, caches = lm.prefill(params, cfg, seq[:, :SWA_PROMPT])
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
    span = 1024 * (-(-win // 1024) + 1)
    n_chunks = SWA_PROMPT // 1024 * cfg.num_layers
    check(spy.chunks == [(1024, span)] * n_chunks,
          f"swa: chunks {sorted(set(spy.chunks))} ({len(spy.chunks)}), "
          f"expected {n_chunks} of (1024, {span})")
    ck = caches["scan"]["b0"]["k"]
    check(ck.shape[2] == win and int(caches["scan"]["b0"]["pos"][0])
          == SWA_PROMPT, f"swa: cache {tuple(ck.shape)}, expected {win} "
          f"slots at position {SWA_PROMPT}")
    times = []
    for t in range(SWA_PROMPT, SWA_PROMPT + SWA_DECODE):
        t0 = time.perf_counter()
        lg, caches = lm.decode_step(params, cfg, seq[:, t:t + 1], caches)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(lg).all()) and lg.shape == (1, cfg.vocab_size),
          f"swa: decode logits {tuple(lg.shape)}, finite "
          f"{bool(torch.isfinite(lg).all())}")
    print(f"# swa gemma-2b-swa full width bf16 (window {win}): prefill "
          f"{SWA_PROMPT} tokens in {pre_ms:.1f} ms ({len(spy.chunks)} "
          f"chunks of 1024 queries x {span} keys), rolling cache of {win} "
          f"slots, {SWA_DECODE} decode steps writing slots 0..."
          f"{SWA_DECODE - 1} again: median {statistics.median(times):.3f} "
          f"ms a step (batch 1); peak memory "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB; gpu {gpu}")
    del params, caches
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# LM training
# --------------------------------------------------------------------------- #
# starcoder2-7b at its published widths (d_model 4608, 36 heads over 4 KV
# heads, d_ff 18432, vocab 49152, bf16) cut to LM_LAYERS of its 32 layers
# (the training state, ~43 B a parameter at the step's peak, must fit one
# 80 GB card); qwen3-moe-30b-a3b at its widths (128 experts, top-8) cut to
# one of its 48 layers
LM_ARCH, LM_LAYERS, LM_STEPS, LM_PROFILE_STEPS = "starcoder2-7b", 4, 10, 5
MOE_ARCH, MOE_LAYERS, MOE_STEPS = "qwen3-moe-30b-a3b", 1, 5
LM_BATCH, LM_SEQ = 2, 2048
LM_PARITY_STEPS = 3
PLAIN_ROWS = 1 << 16      # rows a call of B1's plain version on the LM path
LM_W_ARGS = ["--arch", "yi-34b", "--smoke", "--workers", str(WORKERS),
             "--batch", "8", "--optimizer", "omd", "--compressor",
             "qsgd8_block1024", "--comm-plan", "delta_budget",
             "--comm-budget-mb", "1.0", "--comm-adaptive", "--participation",
             "0.5", "--log-every", "1", "--device", "cuda"]


def plain_quantize_ef_rows(g, e, rand, *, levels=127):
    """`kernels.quantize.quantize_ef_flat` computed by B1's plain version
    on the operands' device (the card), PLAIN_ROWS rows a call: rows are
    independent, so the result is the plain version's over all of them,
    and one call over the LM path's 1.3 M rows would need ~25 GB of
    temporaries beside the training state."""
    import torch
    from repro_torch.kernels.ref import quantize_ef_ref
    n = g.shape[0]
    R = n // 1024
    codes = torch.empty(n, dtype=torch.int8, device=g.device)
    scale = torch.empty(R, dtype=torch.float32, device=g.device)
    e_new = torch.empty(n, dtype=torch.float32, device=g.device)
    for r0 in range(0, R, PLAIN_ROWS):
        r1 = min(R, r0 + PLAIN_ROWS)
        s = slice(r0 * 1024, r1 * 1024)
        c, sc, en = quantize_ef_ref(*(x[s].reshape(-1, 1024)
                                      for x in (g, e, rand)), levels)
        codes[s] = c.reshape(-1)
        scale[r0:r1] = sc.reshape(-1)
        e_new[s] = en.reshape(-1)
    return codes, scale, e_new


class QuantCheck:
    """Wraps `quantize_ef_flat`: each of the first `limit` calls goes to
    the kernel as the caller makes it (B1 with an int level count, B2 with
    a device one), then to its plain version on the same operands and
    levels, PLAIN_ROWS rows at a time, compared bit for bit (codes,
    scales, e'). Later calls go to the kernel alone; `n` counts all."""

    def __init__(self, real, limit=1):
        self.real, self.limit, self.calls, self.n = real, limit, [], 0

    def __call__(self, g, e, rand, *, levels=127):
        import torch
        codes, scale, e_new = self.real(g, e, rand, levels=levels)
        self.n += 1
        if len(self.calls) >= self.limit:
            return codes, scale, e_new
        pc, ps, pe = plain_quantize_ef_rows(g, e, rand, levels=levels)
        dyn = isinstance(levels, torch.Tensor)
        self.calls.append({
            "rows": scale.shape[0], "dyn": dyn, "levels": float(levels),
            "codes": torch.equal(codes, pc), "scale": torch.equal(scale, ps),
            "e": torch.equal(e_new, pe),
            "max_abs_err": (e_new - pe).abs().max().item()})
        del pc, ps, pe
        return codes, scale, e_new


def lm_trainer(dev, arch, layers, seed, strat=None, batch=LM_BATCH,
               seq=LM_SEQ):
    """(trainer, state, batches, cfg, field metrics) of `arch` at its
    published widths cut to `layers` layers: one worker, omd/update,
    qsgd8_block1024 over uniform 4 MiB buckets (one packed B1 launch a
    step), weights and batches (`batch` x `seq` tokens, and an
    encoder-decoder model's encoder frames) from one seeded generator, as
    the trainer's CLI draws them. The field's metrics (the loss and the
    MoE aux losses that entered the gradient) are appended to the list
    each step."""
    import dataclasses

    import torch
    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan
    from repro_torch.data import lm_batch_iterator
    from repro_torch.models import build
    cfg = dataclasses.replace(get(arch), num_layers=layers)
    bundle = build(cfg)
    seen = []

    def field_fn(params, batch, z=None, generator=None):
        grads, metrics = bundle.field_fn(params, batch, z, generator)
        seen.append(metrics)
        return grads, metrics

    dq = DQConfig.from_strategy(strat or single_strategy(), optimizer="omd",
                                lr=1e-4, message="update")
    trainer = dqgan.DQGAN(field_fn=field_fn, dq=dq, device=dev,
                          seed=seed + 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = trainer.init(bundle.init(generator=gen, device=dev,
                                     max_seq=seq))
    enc_shape = ((cfg.encdec.enc_seq, cfg.d_model) if cfg.is_encdec
                 else None)
    return trainer, state, lm_batch_iterator(
        batch, seq, cfg.vocab_size, generator=gen, device=dev,
        enc_shape=enc_shape), cfg, seen


def free_cuda():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_steps(trainer, state, batches, steps, label, seen=()):
    """`steps` trainer steps, each synchronized and timed, with B1's
    launches counted a step. Returns (state, [step_s], [loss], [the MoE
    aux losses of each step's field, from `seen`]); a step with a
    non-finite loss or gradient norm (the norm of the whole gradient, not
    finite exactly when some element is not) fails."""
    import torch
    from repro_torch.kernels import quantize as Q
    times, losses, auxes = [], [], []
    for i in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        before = Q.launches
        t0 = time.perf_counter()
        out = trainer.step(state, batch)
        state = out.state
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(Q.launches - before == 1, f"{label} step {i}: quantize_ef "
              f"launched {Q.launches - before} times, expected 1")
        loss = out.metrics["loss"].item()
        check(math.isfinite(loss), f"{label} step {i}: loss {loss}")
        gn = out.metrics["grad_norm"].item()
        check(math.isfinite(gn), f"{label} step {i}: gradient norm {gn}")
        losses.append(loss)
        if seen:
            auxes.append({k: float(v) for k, v in seen[-1].items()
                          if k.startswith("moe_")})
    return state, times, losses, auxes


def host_params(state):
    from repro_torch import tree as T
    return [x.detach().cpu() for x in T.leaves(state.params)]


def host_breakdown(trainer, state, batch, top=8):
    """Where one step's host time goes: cProfile of one step (the device
    synchronized at its end), the functions of the port by their own
    time."""
    import cProfile
    import pstats

    import torch
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    out = trainer.step(state, batch)
    t_queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], f"{os.path.basename(k[0])}:{k[1]}({k[2]})", v[1])
                   for k, v in stats.items()), reverse=True)[:top]
    print(f"#   host: one step under cProfile {t_all * 1e3:.1f} ms, "
          f"{t_queued * 1e3:.1f} ms of it until the step returned "
          f"(queued); largest own times:")
    for t, name, n in rows:
        print(f"#     {t * 1e3:8.2f} ms {n:6d} calls  {name}")
    return out.state


def lm_profile_b1(tr, st, batches, label, rows, n_elem, gpu):
    """A profiled window of LM_PROFILE_STEPS steps (busy share, kernels a
    step) and B1's device time in it against its bound (bytes: 17 B an
    element and a 4-byte scale a row). The profiler records device
    activity alone, the only events `report_profile` reads (host activity
    would add its cost to the window's wall, and a step of ~24,000 kernels
    makes it slow to read back). Returns (state, B1 ms or None, bound
    ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof_batches = [next(batches) for _ in range(LM_PROFILE_STEPS)]
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in prof_batches:
            st = tr.step(st, b).state
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del prof_batches
    rep = report_profile(prof, f"{label}, 1 worker", LM_PROFILE_STEPS,
                         wall_ms, "quantize_ef")
    del prof
    nbytes = n_elem * 17 + rows * 4
    bound = nbytes / PEAK_BYTES_S * 1e3
    b1_ms = rep["ours_ms"] if rep else None
    print(f"# {label} B1 one launch over {rows} rows ({n_elem} elements, "
          f"{nbytes / 1e9:.2f} GB): device time "
          + (f"{b1_ms:.4f} ms a step, bound {bound:.4f} ms (bytes), bound "
             f"share {bound / b1_ms:.3f}" if b1_ms else "not measured")
          + f"; gpu {gpu} (window and read-back "
          f"{time.perf_counter() - t_prof:.1f} s)")
    return st, b1_ms, bound


def lm_check_b1_step(tr, st, batches, rows, label):
    """One trainer step whose packed operands go through B1 and its plain
    version, compared bit for bit (codes, scales, e'). Returns the
    state."""
    import torch
    from repro_torch.core import error_feedback
    spy = QuantCheck(error_feedback.quantize_ef_flat)
    with mock.patch.object(error_feedback, "quantize_ef_flat", spy):
        st = tr.step(st, next(batches)).state
    torch.cuda.synchronize()
    check(spy.n == 1 and spy.calls[0]["rows"] == rows
          and not spy.calls[0]["dyn"],
          f"{label}: the checked step made {spy.n} B1 calls")
    c = spy.calls[0]
    check(c["codes"] and c["scale"] and c["e"],
          f"{label}: B1 on the step's packed operands ({rows} rows) differs "
          f"from its plain version: {c}")
    print(f"# {label} B1 on one step's packed operands ({rows} rows): "
          f"codes, scales and e' bit-equal to its plain version "
          f"(max|de'| {c['max_abs_err']:.3e})")
    return st


def cli_check_b2_step(args, n_buckets, label):
    """The trainer's CLI with `args`, its first step's `n_buckets` B2
    launches (one a bucket, at the adaptive family's level counts) each
    held bit for bit against B2's plain version on that step's operands
    and levels (codes, scales, e'). Later steps run the kernel alone.
    Returns the CLI's history."""
    from repro_torch.core import error_feedback
    from repro_torch.launch import train
    spy = QuantCheck(error_feedback.quantize_ef_flat, limit=n_buckets)
    with mock.patch.object(error_feedback, "quantize_ef_flat", spy):
        history = train.main(args)
    check(len(spy.calls) == n_buckets and all(c["dyn"] for c in spy.calls),
          f"{label}: step 0 made {len(spy.calls)} B2 calls ({spy.n} in all), "
          f"expected {n_buckets}")
    bad = [c for c in spy.calls if not (c["codes"] and c["scale"] and c["e"])]
    check(not bad, f"{label}: B2 on step 0's operands differs from its plain "
          f"version: {bad}")
    print(f"# {label} B2 on step 0's {n_buckets} buckets "
          f"({sum(c['rows'] for c in spy.calls)} rows, levels "
          f"{[c['levels'] for c in spy.calls]}): codes, scales and e' "
          f"bit-equal to its plain version (max|de'| "
          f"{max(c['max_abs_err'] for c in spy.calls):.3e})")
    return history


def lm_plain_parity(dev, arch, layers, seed, kept, label):
    """The first LM_PARITY_STEPS steps of `lm_trainer(dev, arch, layers,
    seed)` again, with B1's plain version in the step: params
    bit-equal on the host to `kept`, the kernel run's."""
    import torch
    from repro_torch.core import error_feedback
    from repro_torch.kernels import quantize as Q
    tr, st, batches, _, _ = lm_trainer(dev, arch, layers, seed)
    before = Q.launches
    with mock.patch.object(error_feedback, "quantize_ef_flat",
                           plain_quantize_ef_rows):
        for _ in range(LM_PARITY_STEPS):
            st = tr.step(st, next(batches)).state
    torch.cuda.synchronize()
    check(Q.launches == before, f"{label}: the plain steps launched B1")
    plain = host_params(st)
    del tr, st, batches
    free_cuda()
    ndiff = sum(int((a != b).sum()) for a, b in zip(kept, plain))
    check(ndiff == 0, f"{label}: params after {LM_PARITY_STEPS} steps of "
          f"{arch} differ between B1 and its plain version in {ndiff} "
          f"elements")
    print(f"# {label} parity: {LM_PARITY_STEPS} steps of {arch} with B1 and "
          f"with its plain version from one seed: params bit-equal "
          f"({sum(x.numel() for x in kept)} elements, compared on the host)")


def phase_lm_train(dev, gpu):
    """LM training through the trainer on the card (the JAX launcher's LM
    path, B1 once a step over the whole packed gradient):
    (a) starcoder2-7b at full width, LM_LAYERS layers, batch LM_BATCH x
        LM_SEQ, omd, qsgd8_block1024 over uniform 4 MiB buckets, LM_STEPS
        steps: one B1 launch a step, finite losses, median step_s
        (steps 1..) and step 0 apart, peak memory; a profiled window of
        LM_PROFILE_STEPS steps (busy share, kernels a step, B1's device
        time against its bound); one step's host time by function; one
        step with B1's packed operands held bit for bit against its
        plain version; model FLOPs a step over the step time against
        the card's dense bf16 peak (reported);
    (b) the first LM_PARITY_STEPS steps again from the same seed with
        B1's plain version in the step: params bit-equal on the host;
    (c) qwen3-moe-30b-a3b at full width, MOE_LAYERS layer, MOE_STEPS
        steps: finite losses, both aux losses, one B1 launch a step, peak
        memory, median step;
    (d) the trainer's CLI on the card, starcoder2 reduced, --seq 64, 5
        steps: rows with finite step_s, B1 5 launches;
    (e) four stacked workers at yi-34b reduced through the CLI, half
        reporting, adaptive delta_budget at 1 MiB (a family of more than
        one member): B2 once a bucket a step, step 0's launches bit-equal
        to B2's plain version.
    Returns ({path: B1 launches}, {path: B2 launches}, the timed B1
    record's fields for the LM call, (a)'s peak memory, median step and
    B1 launches a step for phase dryrun's calibration)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train

    free_cuda()
    free, total = torch.cuda.mem_get_info()
    print(f"# lm: device memory free {gib(free):.2f} of {gib(total):.2f} GiB")
    b1_paths, b2_paths = {}, {}

    # ---- (a) starcoder2-7b ------------------------------------------------ #
    tr, st, batches, cfg, _ = lm_trainer(dev, LM_ARCH, LM_LAYERS, 7)
    layout = tr._comm(st.params)[0]
    n_params = sum(x.numel() for x in T.leaves(st.params))
    n_elem = sum(b.size for b in layout.buckets)
    rows = n_elem // 1024
    print(f"# lm {LM_ARCH}: {LM_LAYERS} of 32 layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}: "
          f"{n_params} parameters (param_count {cfg.param_count()}); "
          f"{len(layout.buckets)} buckets, {rows} rows of 1024 in B1's "
          f"one launch")
    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    FA.reset_launches()
    kept = None
    times, losses = [], []
    for i in range(LM_STEPS):
        st, t, l, _ = lm_steps(tr, st, batches, 1, LM_ARCH)
        times += t
        losses += l
        if i == LM_PARITY_STEPS - 1:
            kept = host_params(st)       # outside the timed steps
    launches = Q.launches
    check(launches == LM_STEPS and Q.launches_dyn == 0
          and FA.flash_launches == 0,
          f"lm {LM_ARCH}: quantize_ef {launches}, quantize_ef_dyn "
          f"{Q.launches_dyn}, flash_attention {FA.flash_launches} launches "
          f"in {LM_STEPS} steps, expected {LM_STEPS}, 0, 0")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    tokens = LM_BATCH * LM_SEQ
    hd = cfg.head_dim
    flops = tokens * (6 * n_params + 12 * cfg.num_layers * cfg.num_heads
                      * hd * LM_SEQ)
    print(f"# lm {LM_ARCH} train, 1 worker, batch {LM_BATCH} x {LM_SEQ}: "
          f"{LM_STEPS} steps, quantize_ef launches {launches}, median step "
          f"{step_s * 1e3:.3f} ms (first step {times[0] * 1e3:.1f} ms), "
          f"losses {[round(x, 4) for x in losses]}, peak memory "
          f"{gib(peak):.2f} GiB; model FLOPs a step {flops / 1e12:.2f} T "
          f"(6 N tokens + attention), {flops / step_s / 1e12:.1f} TFLOP/s, "
          f"{flops / step_s / PEAK_BF16_FLOP_S:.3f} of the dense bf16 peak; "
          f"gpu {gpu}")
    b1_paths[f"lm {LM_ARCH}"] = launches
    measured = {"peak_bytes": peak, "step_s": step_s,
                "b1_a_step": launches / LM_STEPS}

    st, b1_ms, bound = lm_profile_b1(tr, st, batches, f"lm {LM_ARCH}",
                                     rows, n_elem, gpu)
    st = host_breakdown(tr, st, next(batches))
    st = lm_check_b1_step(tr, st, batches, rows, "lm")
    del tr, st, batches
    free_cuda()

    # ---- (b) the same first steps with B1's plain version ------------- #
    lm_plain_parity(dev, LM_ARCH, LM_LAYERS, 7, kept, "lm")
    del kept

    # ---- (c) qwen3-moe ---------------------------------------------------- #
    tr, st, batches, mcfg, seen = lm_trainer(dev, MOE_ARCH, MOE_LAYERS, 8)
    m_params = sum(x.numel() for x in T.leaves(st.params))
    m_rows = sum(b.size for b in tr._comm(st.params)[0].buckets) // 1024
    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    st, times, losses, auxes = lm_steps(tr, st, batches, MOE_STEPS,
                                        MOE_ARCH, seen)
    check(Q.launches == MOE_STEPS, f"lm {MOE_ARCH}: quantize_ef launched "
          f"{Q.launches} times in {MOE_STEPS} steps")
    check(len(auxes) == MOE_STEPS
          and all(sorted(a) == ["moe_load_balance", "moe_router_z"]
              and all(math.isfinite(v) for v in a.values()) for a in auxes),
          f"lm {MOE_ARCH}: aux losses {auxes}")
    b1_paths[f"lm {MOE_ARCH}"] = Q.launches
    print(f"# lm {MOE_ARCH} train, {MOE_LAYERS} of 48 layers, "
          f"{mcfg.moe.num_experts} experts top-{mcfg.moe.top_k}, batch "
          f"{LM_BATCH} x {LM_SEQ}: {m_params} parameters, B1 over {m_rows} "
          f"rows, {MOE_STEPS} steps, quantize_ef launches {Q.launches}, "
          f"median step {statistics.median(times[1:]) * 1e3:.3f} ms (first "
          f"{times[0] * 1e3:.1f} ms), losses "
          f"{[round(x, 4) for x in losses]}, aux (last step) "
          f"{ {k: round(v, 6) for k, v in auxes[-1].items()} }, peak memory "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB; gpu {gpu}")
    del tr, st, batches, seen
    free_cuda()

    # ---- (d) the CLI on the card ------------------------------------------ #
    Q.reset_launches()
    history = train.main(["--arch", LM_ARCH, "--smoke", "--seq", "64",
                          "--steps", "5", "--optimizer", "omd",
                          "--compressor", "qsgd8_block1024", "--comm-plan",
                          "uniform", "--log-every", "1", "--device", "cuda"])
    check_rows(history, 5)
    check(all(math.isfinite(r["step_s"]) and r["step_s"] > 0
              for r in history), f"lm cli: step_s {history}")
    check(Q.launches == 5 and Q.launches_dyn == 0,
          f"lm cli: quantize_ef {Q.launches}, quantize_ef_dyn "
          f"{Q.launches_dyn} launches in 5 steps, expected 5, 0")
    b1_paths[f"lm cli {LM_ARCH} smoke"] = Q.launches
    print(f"# lm cli {LM_ARCH} --smoke --seq 64: 5 rows, quantize_ef "
          f"launches {Q.launches}, median step "
          f"{statistics.median(r['step_s'] for r in history[1:]) * 1e3:.3f} "
          f"ms")

    # ---- (e) four stacked workers, B2 ------------------------------------ #
    import dataclasses

    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan
    from repro_torch.models import build
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Strategy)
    ycfg = get("yi-34b").reduced()
    strat = Strategy(compression=Compression(
        compressor="qsgd8_block1024", plan="delta_budget", budget_mb=1.0,
        adaptive=True), exchange=ExchangePlan(kind="sim",
                                              worker_axes=("data",)),
        participation=Participation(fraction=0.5))
    ytr = dqgan.DQGAN(field_fn=build(ycfg).field_fn,
                      dq=DQConfig.from_strategy(strat, optimizer="omd"),
                      device=dev, workers=WORKERS)
    yparams = build(ycfg).init(device=dev)
    family = ytr._family(yparams)
    n_buckets = len(ytr._comm(yparams)[0].buckets)
    table = family.levels_table()
    members = {tuple(r) for r in table}
    check(len(members) > 1, f"lm 4 workers: the family has one member "
          f"({family.describe()})")
    del ytr, yparams
    Q.reset_launches()
    steps = 5
    history = cli_check_b2_step(LM_W_ARGS + ["--steps", str(steps)],
                                n_buckets, "lm 4 workers")
    check_rows(history, steps)
    check(Q.launches_dyn == steps * n_buckets and Q.launches == 0,
          f"lm 4 workers: quantize_ef_dyn {Q.launches_dyn}, quantize_ef "
          f"{Q.launches} launches in {steps} steps, expected "
          f"{steps * n_buckets} and 0")
    check(all(r.get("participants") == N_PART for r in history),
          "lm 4 workers: participants")
    b2_paths["lm yi-34b smoke 4 workers"] = Q.launches_dyn
    print(f"# lm yi-34b reduced, {WORKERS} workers ({N_PART} reporting), "
          f"adaptive delta_budget 1.0 MiB, {family.describe()}: {steps} "
          f"steps, quantize_ef_dyn launches {Q.launches_dyn} ({n_buckets} "
          f"buckets a step), median step "
          f"{statistics.median(r['step_s'] for r in history[1:]) * 1e3:.3f} "
          f"ms")
    free_cuda()
    return b1_paths, b2_paths, {"lm_rows": rows, "lm_ms": b1_ms,
                                "lm_bound_ms": bound}, measured


# --------------------------------------------------------------------------- #
# the rest of the LM zoo: the SSD and RG-LRU mixers, the encoder-decoder
# --------------------------------------------------------------------------- #
# mamba2-1.3b trains at all 48 of its layers (1.447 B parameters: the
# training state, 43 B a parameter at the step's peak, fits the card);
# recurrentgemma-2b at 2 of its 26 (rglru, rglru: the full model's
# unscanned tail). Its two untied 256,000 x 2560 embeddings alone are
# 1.31 B parameters, and its step peaks at 52 B a parameter: at 3 layers
# (one period, 1.57 B parameters) the exchange asked for 5.84 GiB with
# 69.92 allocated and ran out of memory, at 2 it peaks at 72.27 GiB, which
# fits only with the allocator's expandable segments (set for this phase;
# without them 8.34 GiB stayed reserved but unallocated). whisper-tiny
# trains whole, at Whisper's 448-token decoder context.
ZOO_SSD, ZOO_SSD_LAYERS, ZOO_STEPS = "mamba2-1.3b", 48, 10
ZOO_RG, ZOO_RG_LAYERS, ZOO_RG_STEPS, ZOO_RG_BATCH = (
    "recurrentgemma-2b", 2, 5, 1)
ZOO_WH, ZOO_WH_BATCH, ZOO_WH_SEQ, ZOO_WH_STEPS = "whisper-tiny", 16, 448, 10
ZOO_LONG, ZOO_LONG_K = 4096, 8           # prefill + decode == forward
ZOO_RG_DECODE = 32                       # recurrentgemma-2b, 26 layers
ZOO_WH_PROMPT, ZOO_WH_DECODE = 64, 32    # whisper serving, batch 4
ZOO_W_ARGS = ["--arch", ZOO_SSD, "--smoke", "--workers", str(WORKERS),
              "--batch", "8", "--seq", "64", "--optimizer", "omd",
              "--compressor", "qsgd8_block1024", "--comm-plan",
              "delta_budget", "--comm-budget-mb", "0.5", "--comm-adaptive",
              "--participation", "0.5", "--log-every", "1", "--device",
              "cuda"]


def zoo_train_ssd(dev, gpu, b1_paths):
    """mamba2-1.3b at all 48 layers: ZOO_STEPS steps (B1 once a step,
    finite losses and gradients), a profiled window, one step's packed
    operands through B1 and its plain version bit for bit, then
    LM_PARITY_STEPS steps again from the seed with the plain version:
    params bit-equal on the host. Returns (B1's record for the call, the
    peak memory, median step and B1 launches a step of the timed
    steps)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd as SSD

    tr, st, batches, cfg, _ = lm_trainer(dev, ZOO_SSD, ZOO_SSD_LAYERS, 23)
    layout = tr._comm(st.params)[0]
    n_params = sum(x.numel() for x in T.leaves(st.params))
    n_elem = sum(b.size for b in layout.buckets)
    rows = n_elem // 1024
    s = cfg.ssm
    print(f"# zoo {ZOO_SSD}: {ZOO_SSD_LAYERS} of 48 layers, d_model "
          f"{cfg.d_model}, SSD state {s.state_dim}, head_dim {s.head_dim}, "
          f"expand {s.expand}, conv {s.conv_width}, chunk {s.chunk_size}, "
          f"vocab {cfg.vocab_size}, {cfg.param_dtype}: {n_params} "
          f"parameters (param_count {cfg.param_count()}); "
          f"{len(layout.buckets)} buckets, {rows} rows of 1024 in B1's one "
          f"launch")
    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    FA.reset_launches()
    SSD.reset_launches()
    kept, times, losses = None, [], []
    for i in range(ZOO_STEPS):
        st, t, l, _ = lm_steps(tr, st, batches, 1, ZOO_SSD)
        times += t
        losses += l
        if i == LM_PARITY_STEPS - 1:
            kept = host_params(st)       # outside the timed steps
    check_ssd_path(f"zoo {ZOO_SSD}", (SSD.ssd_launches, SSD.ssd_bwd_launches),
                   ssd_layers(cfg), ZOO_STEPS)
    launches = Q.launches
    check(launches == ZOO_STEPS and Q.launches_dyn == 0
          and FA.flash_launches == 0 and FA.launches == 0,
          f"zoo {ZOO_SSD}: quantize_ef {launches}, quantize_ef_dyn "
          f"{Q.launches_dyn}, flash_attention {FA.flash_launches}, "
          f"paged_attention {FA.launches} launches in {ZOO_STEPS} steps, "
          f"expected {ZOO_STEPS}, 0, 0, 0")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    print(f"# zoo {ZOO_SSD} train, 1 worker, batch {LM_BATCH} x {LM_SEQ}: "
          f"{ZOO_STEPS} steps, quantize_ef launches {launches}, gradients "
          f"finite every step, median step {step_s * 1e3:.3f} ms (first "
          f"step {times[0] * 1e3:.1f} ms), losses "
          f"{[round(x, 4) for x in losses]}, peak memory {gib(peak):.2f} "
          f"GiB ({peak / n_params:.1f} B a parameter), ssd_chunked "
          f"{SSD_PATHS[f'zoo {ZOO_SSD}']} (forward, backward) calls; gpu "
          f"{gpu}")
    b1_paths[f"zoo {ZOO_SSD}"] = launches
    measured = {"peak_bytes": peak, "step_s": step_s,
                "b1_a_step": launches / ZOO_STEPS}

    st, b1_ms, bound = lm_profile_b1(tr, st, batches, f"zoo {ZOO_SSD}",
                                     rows, n_elem, gpu)
    st = lm_check_b1_step(tr, st, batches, rows, "zoo")
    del tr, st, batches
    free_cuda()
    lm_plain_parity(dev, ZOO_SSD, ZOO_SSD_LAYERS, 23, kept, "zoo")
    return ({"zoo_rows": rows, "zoo_ms": b1_ms, "zoo_bound_ms": bound},
            measured)


def zoo_train_other(dev, gpu, b1_paths):
    """recurrentgemma-2b at ZOO_RG_LAYERS layers, batch ZOO_RG_BATCH x
    LM_SEQ, and whisper-tiny whole, batch ZOO_WH_BATCH x ZOO_WH_SEQ with
    1500 encoder frames a row: finite losses and gradients, B1 once a
    step, median step, peak memory. Returns {arch: peak memory}."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import quantize as Q
    from repro_torch.models.model import pattern_kinds
    peaks = {}
    for arch, layers, steps, batch, seq in (
            (ZOO_RG, ZOO_RG_LAYERS, ZOO_RG_STEPS, ZOO_RG_BATCH, LM_SEQ),
            (ZOO_WH, 4, ZOO_WH_STEPS, ZOO_WH_BATCH, ZOO_WH_SEQ)):
        print(f"# zoo {arch}: {gib(torch.cuda.memory_allocated()):.2f} GiB "
              f"allocated before the trainer")
        tr, st, batches, cfg, _ = lm_trainer(dev, arch, layers, 29,
                                             batch=batch, seq=seq)
        n_params = sum(x.numel() for x in T.leaves(st.params))
        rows = sum(b.size for b in tr._comm(st.params)[0].buckets) // 1024
        torch.cuda.reset_peak_memory_stats()
        Q.reset_launches()
        st, times, losses, _ = lm_steps(tr, st, batches, steps, arch)
        check(Q.launches == steps, f"zoo {arch}: quantize_ef launched "
              f"{Q.launches} times in {steps} steps")
        b1_paths[f"zoo {arch}"] = Q.launches
        peak = torch.cuda.max_memory_allocated()
        what = (f"{layers} of 26 layers "
                f"({', '.join(pattern_kinds(cfg))})" if arch == ZOO_RG else
                f"{cfg.encdec.enc_layers} + {layers} layers, "
                f"{cfg.encdec.enc_seq} encoder frames")
        print(f"# zoo {arch} train, {what}, batch {batch} x {seq}: "
              f"{n_params} parameters, B1 over {rows} rows, {steps} steps, "
              f"quantize_ef launches {Q.launches}, gradients finite every "
              f"step, median step {statistics.median(times[1:]) * 1e3:.3f} "
              f"ms (first {times[0] * 1e3:.1f} ms), losses "
              f"{[round(x, 4) for x in losses]}, peak memory {gib(peak):.2f} "
              f"GiB; gpu {gpu}")
        peaks[arch] = peak
        del tr, st, batches
        free_cuda()
    return peaks


def zoo_serve_ssd(dev, gpu):
    """mamba2-1.3b at 48 layers through the paged engine: in bf16 the
    serving traffic (S_BATCH requests of S_PROMPT + S_GEN tokens; decode
    step, tokens a second, kernels a step, busy share); in f32, 6 ragged
    requests with churn (prefilled at a bucket, claimed below every
    bucket, slots and their state lanes reused): engine == sequential."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import build_serve_config
    from repro_torch.models import model as lm
    from repro_torch.serve import (Engine, Request, SequentialGenerator,
                                   ServeConfig)
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch import serve
    cfg = get(ZOO_SSD)
    FA.reset_launches()
    Q.reset_launches()
    SSD.reset_launches()
    res = serve.main(["--arch", ZOO_SSD] + S_ARGS[2:])
    check_ssd_path(f"zoo serve {ZOO_SSD} bf16",
                   (SSD.ssd_launches, SSD.ssd_bwd_launches), ssd_layers(cfg))
    row, steps = res["row"], res["stats"]["steps"]
    check(row["generated"] == S_BATCH * S_GEN and steps == S_GEN - 1
          and FA.launches == FA.flash_launches == Q.launches
          == Q.launches_dyn == 0,
          f"zoo serve {ZOO_SSD}: {row['generated']} tokens in {steps} "
          f"engine steps; launches B1 {Q.launches}, B2 {Q.launches_dyn}, "
          f"B3 {FA.launches}, B4 {FA.flash_launches}")
    del res
    free_cuda()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(31)
    params = lm.init(cfg, generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (S_BATCH, S_PROMPT),
                            generator=gen, device=dev).tolist()
    reqs = [Request(rid=i, prompt=prompts[i], max_new=S_GEN)
            for i in range(S_BATCH)]
    eng = Engine(cfg, build_serve_config(S_PROMPT, S_GEN, S_BATCH), params)
    _, _, prof, peak = run_engine(eng, reqs, profile_steps=10,
                                  label=f"zoo serve {ZOO_SSD} bf16")
    print(f"# zoo serve {ZOO_SSD} bf16, 48 layers, through the launcher: "
          f"{S_BATCH} requests of {S_PROMPT} + {S_GEN}, {row['generated']} "
          f"tokens in {steps} engine steps, {row['tokens_per_s']} tokens/s, "
          f"median decode step {row['decode_step_s'] * 1e3:.3f} ms; "
          + (f"{prof['kernels']:.0f} kernels a decode step, busy share "
             f"{prof['busy_share']:.3f}" if prof else "profile not measured")
          + f", decode peak {gib(peak):.2f} GiB ({time.perf_counter() - t0:.1f}"
          f" s with the profiled engine); gpu {gpu}")
    del eng, params
    free_cuda()

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    params = lm.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        37), device=dev)
    scfg = ServeConfig(max_batch=4, block_size=16, num_blocks=4 * 20 + 2,
                       max_blocks_per_seq=20,
                       prompt_buckets=(16, 32, 64, 128, 256))
    rs = np.random.RandomState(7)
    reqs = [Request(rid=i, prompt=rs.randint(1, cfg.vocab_size, P).tolist(),
                    max_new=G)
            for i, (P, G) in enumerate([(20, 8), (300, 8), (12, 6),
                                        (150, 8), (256, 5), (7, 8)])]
    eng = Engine(cfg, scfg, params)
    SSD.reset_launches()
    for r in reqs[:3]:
        eng.submit(r)
    for r in reqs[3:]:
        eng.step()
        eng.submit(r)
    while not eng.idle:
        eng.step()
    check_ssd_path(f"zoo serve {ZOO_SSD} f32 engine",
                   (SSD.ssd_launches, SSD.ssd_bwd_launches), ssd_layers(cfg))
    seq = SequentialGenerator(cfg, scfg, params)
    diff = [r.rid for r in reqs
            if seq.generate(list(r.prompt), r.max_new, rid=r.rid)
            != eng.outputs[r.rid]]
    check(not diff, f"zoo serve f32: engine and sequential differ on "
          f"requests {diff}")
    print(f"# zoo serve {ZOO_SSD} f32, 48 layers, TF32 off: 6 requests "
          f"(prompts {[len(r.prompt) for r in reqs]}), 4 slots, churn: "
          f"engine == sequential, token for token "
          f"({sum(len(v) for v in eng.outputs.values())} tokens, "
          f"{eng.steps} engine steps, {time.perf_counter() - t0:.1f} s); "
          f"ssd_chunked (forward, backward) calls: the launcher's bf16 run "
          f"{SSD_PATHS[f'zoo serve {ZOO_SSD} bf16']}, the f32 engine's "
          f"{SSD_PATHS[f'zoo serve {ZOO_SSD} f32 engine']}")
    del eng, seq, params
    free_cuda()


def zoo_match_forward(params, cfg, tokens, P, k, label, ref_cfg=None,
                      enc=None, dense_ref=False):
    """prefill(P) and k teacher-forced decode steps against one forward
    over P + k tokens (its last k + 1 positions): float32, within 1e-4 of
    the largest |logit|. `ref_cfg` runs the forward (another SSD chunk
    size); with `dense_ref` the forward attends through attention_dense
    at any length (attention_chunked needs a multiple of 1024). Returns
    the largest difference and |logit|."""
    import contextlib

    import torch
    from repro_torch.models import layers
    from repro_torch.models import model as lm
    dev = tokens.device
    with torch.no_grad():
        lg, caches = lm.prefill(params, cfg, tokens[:, :P], enc,
                                max_len=P + k)
        got = [lg]
        for t in range(P, P + k):
            lg, caches = lm.decode_step(params, cfg, tokens[:, t:t + 1],
                                        caches)
            got.append(lg)
        del caches
        enc_out = lm.encode(params, cfg, enc) if enc is not None else None
        rc = ref_cfg or cfg
        with (mock.patch.object(layers, "_CHUNKED_PREFILL", 1 << 30)
              if dense_ref else contextlib.nullcontext()):
            hidden, _, _ = lm.forward(params, rc, tokens[:, :P + k],
                                      torch.arange(P + k, device=dev),
                                      enc_out=enc_out)
        ref = lm.logits_fn(params, rc, hidden[:, P - 1:])
    got = torch.stack(got, 1)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-4 * scale, f"zoo {label}: prefill + decode logits off "
          f"the forward by {err:.3e} (max |logit| {scale:.3e})")
    return err, scale


def zoo_long(dev, gpu):
    """Long prompts, float32 at full width: mamba2 at 4 layers, prefill of
    ZOO_LONG tokens (16 SSD chunks) + ZOO_LONG_K decode steps against a
    forward at the largest chunk size dividing ZOO_LONG + ZOO_LONG_K (228:
    the chunked SSD computes one function at every chunk size); recurrentgemma
    at 5 layers (a period and the two-layer tail), the prefill through
    attention_chunked and the rolling fill of its 2048-slot window,
    against a forward through attention_dense over all positions; then
    recurrentgemma-2b at its 26 layers in bf16: the same prompt and
    ZOO_RG_DECODE decode steps, timed."""
    import dataclasses

    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import model as lm
    gen = torch.Generator(device=dev).manual_seed(41)
    P, k = ZOO_LONG, ZOO_LONG_K

    cfg = dataclasses.replace(get(ZOO_SSD), num_layers=4,
                              param_dtype="float32")
    params = lm.init(cfg, generator=gen, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (1, P + k), generator=gen,
                         device=dev)
    # the forward over P + k runs at the largest chunk size that divides it
    chunk = max(c for c in range(1, cfg.ssm.chunk_size + 1)
                if (P + k) % c == 0)
    ref_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk_size=chunk))
    SSD.reset_launches()
    err, scale = zoo_match_forward(params, cfg, toks, P, k, "long mamba2",
                                   ref_cfg=ref_cfg)
    check_ssd_path(f"zoo long {ZOO_SSD} f32",
                   (SSD.ssd_launches, SSD.ssd_bwd_launches), ssd_layers(cfg))
    print(f"# zoo long {ZOO_SSD} f32, 4 layers: prefill {P} "
          f"({P // cfg.ssm.chunk_size} SSD chunks) + {k} decode steps vs a "
          f"forward over {P + k} at chunk {chunk}: max |dlogit| {err:.3e} "
          f"(max |logit| {scale:.3e}); ssd_chunked (forward, backward) "
          f"calls {SSD_PATHS[f'zoo long {ZOO_SSD} f32']}")
    del params
    free_cuda()

    cfg = dataclasses.replace(get(ZOO_RG), num_layers=5,
                              param_dtype="float32")
    params = lm.init(cfg, generator=gen, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (1, P + k), generator=gen,
                         device=dev)
    with ChunkSpy() as spy:
        err, scale = zoo_match_forward(params, cfg, toks, P, k,
                                       "long recurrentgemma", dense_ref=True)
    # the prefill's one attention layer went through attention_chunked
    check(spy.calls == [P], f"zoo long: attention_chunked calls "
          f"{spy.calls}, expected [{P}]")
    print(f"# zoo long {ZOO_RG} f32, 5 layers (a period + the 2-layer "
          f"tail): prefill {P} (attention_chunked, {len(spy.chunks)} chunks "
          f"of {spy.chunks[0][0]} x {spy.chunks[0][1]} keys; rolling fill of "
          f"{cfg.attention_window} slots; the RG-LRU scan over {P} tokens) "
          f"+ {k} decode steps vs a forward through attention_dense over "
          f"{P + k}: max |dlogit| {err:.3e} (max |logit| {scale:.3e})")
    del params
    free_cuda()

    cfg = get(ZOO_RG)
    params = lm.init(cfg, generator=gen, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (1, P + ZOO_RG_DECODE),
                         generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, caches = lm.prefill(params, cfg, toks[:, :P])
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for t in range(P, P + ZOO_RG_DECODE):
            t0 = time.perf_counter()
            lg, caches = lm.decode_step(params, cfg, toks[:, t:t + 1],
                                        caches)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(lg).all()), "zoo long: recurrentgemma-2b "
          "decode logits not finite")
    n_params = sum(x.numel() for x in T.leaves(params))
    print(f"# zoo {ZOO_RG} bf16, all 26 layers ({n_params} parameters): "
          f"prefill {P} tokens in {pre_ms:.1f} ms, {ZOO_RG_DECODE} decode "
          f"steps: median {statistics.median(times):.3f} ms a step (batch "
          f"1); gpu {gpu}")
    del params, caches
    free_cuda()


def zoo_serve_whisper(dev, gpu):
    """whisper-tiny at full size in float32: the encoder over 1500 frames,
    prefill of ZOO_WH_PROMPT tokens (enc_embeds=) and ZOO_WH_DECODE decode
    steps at batch 4 against one forward; then the decode step timed."""
    import dataclasses

    import torch
    from repro_torch.configs import get
    from repro_torch.data.synthetic import enc_embeds
    from repro_torch.models import model as lm
    cfg = dataclasses.replace(get(ZOO_WH), param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(43)
    params = lm.init(cfg, generator=gen, device=dev, max_seq=ZOO_WH_SEQ)
    P, k = ZOO_WH_PROMPT, ZOO_WH_DECODE
    toks = torch.randint(1, cfg.vocab_size, (4, P + k), generator=gen,
                         device=dev)
    enc = enc_embeds(torch.randn((4, cfg.encdec.enc_seq, cfg.d_model),
                                 generator=gen, device=dev))
    err, scale = zoo_match_forward(params, cfg, toks, P, k, "whisper",
                                   enc=enc)
    with torch.no_grad():
        _, caches = lm.prefill(params, cfg, toks[:, :P], enc, max_len=P + k)
        times = []
        for t in range(P, P + k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.decode_step(params, cfg, toks[:, t:t + 1], caches)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"# zoo serve {ZOO_WH} f32 (4 + 4 layers, {cfg.encdec.enc_seq} "
          f"frames), batch 4: prefill {P} + {k} decode steps vs one "
          f"forward: max |dlogit| {err:.3e} (max |logit| {scale:.3e}); "
          f"median decode step {statistics.median(times):.3f} ms; gpu {gpu}")
    del params, caches
    free_cuda()


def zoo_cli(dev, b1_paths, b2_paths):
    """The trainer's CLI on the card for each new arch (reduced, --seq 64,
    5 steps: B1 5 launches), and four stacked workers on mamba2 reduced,
    half reporting, adaptive delta_budget 0.5 MiB (a family of more than
    one member): B2 once a bucket a step, step 0's launches bit-equal to
    B2's plain version."""
    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Strategy)
    for arch in (ZOO_SSD, ZOO_RG, ZOO_WH):
        Q.reset_launches()
        history = train.main(["--arch", arch, "--smoke", "--seq", "64",
                              "--steps", "5", "--optimizer", "omd",
                              "--compressor", "qsgd8_block1024",
                              "--comm-plan", "uniform", "--log-every", "1",
                              "--device", "cuda"])
        check_rows(history, 5)
        check(Q.launches == 5 and Q.launches_dyn == 0,
              f"zoo cli {arch}: quantize_ef {Q.launches}, quantize_ef_dyn "
              f"{Q.launches_dyn} launches in 5 steps, expected 5, 0")
        b1_paths[f"zoo cli {arch} smoke"] = Q.launches
        print(f"# zoo cli {arch} --smoke --seq 64: 5 rows, quantize_ef "
              f"launches {Q.launches}, median step "
              f"{statistics.median(r['step_s'] for r in history[1:]) * 1e3:.3f}"
              f" ms")
    cfg = get(ZOO_SSD).reduced()
    strat = Strategy(compression=Compression(
        compressor="qsgd8_block1024", plan="delta_budget", budget_mb=0.5,
        adaptive=True), exchange=ExchangePlan(kind="sim",
                                              worker_axes=("data",)),
        participation=Participation(fraction=0.5))
    tr = dqgan.DQGAN(field_fn=build(cfg).field_fn,
                     dq=DQConfig.from_strategy(strat, optimizer="omd"),
                     device=dev, workers=WORKERS)
    params = build(cfg).init(device=dev, max_seq=64)
    family = tr._family(params)
    n_buckets = len(tr._comm(params)[0].buckets)
    check(len({tuple(r) for r in family.levels_table()}) > 1,
          f"zoo 4 workers: the family has one member ({family.describe()})")
    del tr, params
    Q.reset_launches()
    steps = 5
    history = cli_check_b2_step(ZOO_W_ARGS + ["--steps", str(steps)],
                                n_buckets, "zoo 4 workers")
    check_rows(history, steps)
    check(Q.launches_dyn == steps * n_buckets and Q.launches == 0,
          f"zoo 4 workers: quantize_ef_dyn {Q.launches_dyn}, quantize_ef "
          f"{Q.launches} launches in {steps} steps, expected "
          f"{steps * n_buckets} and 0")
    check(all(r.get("participants") == N_PART for r in history),
          "zoo 4 workers: participants")
    b2_paths[f"zoo {ZOO_SSD} smoke 4 workers"] = Q.launches_dyn
    print(f"# zoo {ZOO_SSD} reduced, {WORKERS} workers ({N_PART} reporting), "
          f"adaptive delta_budget 0.5 MiB, {family.describe()}: {steps} "
          f"steps, quantize_ef_dyn launches {Q.launches_dyn} ({n_buckets} "
          f"buckets a step), median step "
          f"{statistics.median(r['step_s'] for r in history[1:]) * 1e3:.3f} "
          f"ms")


def phase_zoo(dev, gpu):
    """The rest of the LM zoo on the card: the SSD mixer (mamba2-1.3b), the
    RG-LRU mixer with windowed attention (recurrentgemma-2b) and the
    encoder-decoder (whisper-tiny), trained through B1 and served. Each
    part prints its wall time. Returns ({path: B1 launches}, {path: B2
    launches}, B1's record for its call over mamba2's gradient, and
    mamba2's peak memory, median step and B1 launches a step with the
    three archs' peaks by arch)."""
    import torch
    b1_paths, b2_paths = {}, {}
    free_cuda()
    # whole segments freed by empty_cache and mapped as they grow: the
    # training steps' peaks leave no reserved-but-unallocated gaps
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        call, measured = timed("zoo train mamba2", zoo_train_ssd, dev, gpu,
                               b1_paths)
        measured["peaks"] = {ZOO_SSD: measured["peak_bytes"], **timed(
            "zoo train recurrentgemma, whisper", zoo_train_other, dev, gpu,
            b1_paths)}
    finally:
        free_cuda()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    timed("zoo serve mamba2", zoo_serve_ssd, dev, gpu)
    timed("zoo long", zoo_long, dev, gpu)
    timed("zoo serve whisper", zoo_serve_whisper, dev, gpu)
    timed("zoo cli", zoo_cli, dev, b1_paths, b2_paths)
    return b1_paths, b2_paths, call, measured


# --------------------------------------------------------------------------- #
# the dry-run: launch tooling on the meta device
# --------------------------------------------------------------------------- #
DRYRUN_JOBS = 8            # pool processes for the sweep (the machine's cores)
DRYRUN_LIMIT_S = 120.0
# the pure full-attention archs: the JAX package's `applicable` skips
# exactly these at long_500k
DRYRUN_SKIPS = {"gemma-2b", "starcoder2-7b", "yi-34b", "chameleon-34b",
                "command-r-plus-104b", "qwen3-moe-30b-a3b", "arctic-480b",
                "whisper-tiny"}


def dryrun_combo(job):
    """One single-mesh combo of the dry-run, in a pool process: (its
    record, whether the process initialized CUDA)."""
    import torch
    from repro_torch.launch import dryrun
    rec = dryrun.run_combo(*job, False, quiet=True)
    return rec, torch.cuda.is_initialized()


def phase_dryrun(gpu, lm_meas, zoo_meas):
    """The launch tooling (`repro_torch.launch.dryrun`) on the meta device:
    (a) the sweep: all 44 single-mesh (arch x shape) combos at published
        widths, over DRYRUN_JOBS processes, the training steps first;
        every record ok or skip, skip exactly at long_500k of the pure
        full-attention archs, and no device memory used (the parent's
        allocated bytes unchanged, no pool process initialized CUDA);
    (b) the calibration: the two LM steps phases lm train and zoo measured
        (starcoder2-7b at LM_LAYERS layers, mamba2-1.3b at
        ZOO_SSD_LAYERS, batch LM_BATCH x LM_SEQ, omd, qsgd8_block1024
        over uniform 4 MiB buckets, one worker) traced on the meta device:
        the forecast peak within 0.85-1.15 of the measured one, the traced
        FLOPs at least the model FLOPs, B1 once a step as the card
        launched it; the step's model-FLOPs share of the dense bf16 peak
        (reported).
    The phase must take less than DRYRUN_LIMIT_S."""
    import dataclasses
    import multiprocessing

    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    jobs = [(a, s) for a, s, _ in dryrun.all_combos("single")]
    jobs.sort(key=lambda j: j[1] != "train_4k")
    with multiprocessing.get_context("spawn").Pool(DRYRUN_JOBS) as pool:
        out = pool.map(dryrun_combo, jobs, chunksize=1)
    after = torch.cuda.memory_allocated()
    recs = [r for r, _ in out]
    for rec in recs:
        print(f"# dryrun {json.dumps(dryrun.summary_line(rec))}")
    errors = [(r["arch"], r["shape"], r.get("error")) for r in recs
              if r["status"] not in ("ok", "skip")]
    check(len(recs) == 44 and not errors,
          f"dryrun: {len(recs)} records, errors {errors}")
    skips = {(r["arch"], r["shape"]) for r in recs if r["status"] == "skip"}
    check(skips == {(a, "long_500k") for a in DRYRUN_SKIPS},
          f"dryrun: skipped {sorted(skips)}")
    for a in DRYRUN_SKIPS | {r["arch"] for r in recs}:
        cfg = configs.get(a)
        check(dryrun.applicable(cfg, configs.SHAPES["long_500k"])[0]
              == (a not in DRYRUN_SKIPS), f"dryrun: applicable({a})")
    check(before == after and not any(cu for _, cu in out),
          f"dryrun: device memory {before} -> {after} bytes, CUDA "
          f"initialized in {sum(cu for _, cu in out)} pool processes")
    # every combo a rank of the model axis under the reference's layout
    # (fsdp above 10 B parameters): its parameters the JAX layout's
    # per-device bytes, and for prefill and decode its cache too
    for r in recs:
        if r["status"] != "ok":
            continue
        big = r["params"] > 10e9
        serving = r["shape"] != "train_4k"
        check(r["model_axis"] == 16 and "layout_traced" not in r
              and r["layout"] == ("fsdp" if big else "dp")
              and r["param_bytes_per_rank"]
              == r["param_bytes_per_device"]["bytes"]
              and (not serving or r["cache_bytes_per_rank"]
                   == r["cache_bytes_per_device"]["bytes"])
              and (serving or r["n_workers"] == (1 if big else 16)),
              f"dryrun {r['arch']} {r['shape']}: layout {r['layout']}, "
              f"model axis {r['model_axis']}, workers {r.get('n_workers')}, "
              f"cache {r.get('cache_bytes_per_rank')} against "
              f"{r.get('cache_bytes_per_device')}, parameters "
              f"{r['param_bytes_per_rank']} against "
              f"{r['param_bytes_per_device']['bytes']}")
    fits = sorted(f"{r['arch']}/{r['shape']}" for r in recs if r.get("fits"))
    print(f"# dryrun sweep: {len(recs)} combos over {DRYRUN_JOBS} processes "
          f"in {time.perf_counter() - t0:.1f} s, {len(recs) - len(skips)} "
          f"ok, {len(skips)} skip, device memory {before} -> {after} bytes; "
          f"fit one 80 GB card: {fits}")

    # ---- (b) the calibration against this run's two LM steps ---------- #
    for label, arch, layers, meas in (
            ("lm train", LM_ARCH, LM_LAYERS, lm_meas),
            ("zoo", ZOO_SSD, ZOO_SSD_LAYERS, zoo_meas)):
        cfg = dataclasses.replace(configs.get(arch), num_layers=layers)
        shape = configs.InputShape(f"{arch}-{layers}", LM_SEQ, LM_BATCH,
                                   "train")
        t1 = time.perf_counter()
        res = dryrun.trace_train(cfg, shape, single_strategy(), ranks=1,
                                 optimizer="omd", lr=1e-4, message="update")
        ratio = res["peak_bytes"] / meas["peak_bytes"]
        mf = dryrun.model_flops(cfg, shape)
        share = mf / meas["step_s"] / PEAK_BF16_FLOP_S
        print(f"# dryrun calibration {arch}, {layers} layers, batch "
              f"{LM_BATCH} x {LM_SEQ} ({label}): forecast peak "
              f"{gib(res['peak_bytes']):.2f} GiB against "
              f"{gib(meas['peak_bytes']):.2f} measured (ratio {ratio:.3f}); "
              f"traced FLOPs {res['flops'] / 1e12:.3f} T, model FLOPs "
              f"{mf / 1e12:.3f} T; median step {meas['step_s'] * 1e3:.3f} "
              f"ms: model FLOPs share {share:.4f} of "
              f"{PEAK_BF16_FLOP_S / 1e12:.0f} TFLOP/s; meta launches "
              f"{res['kernels_meta']}, B1 on the card "
              f"{meas['b1_a_step']:.0f} a step; trace "
              f"{time.perf_counter() - t1:.1f} s; gpu {gpu}")
        check(0.85 <= ratio <= 1.15, f"dryrun {arch}: forecast peak "
              f"{res['peak_bytes']} against {meas['peak_bytes']} measured, "
              f"ratio {ratio:.3f}")
        check(res["flops"] >= mf, f"dryrun {arch}: traced FLOPs "
              f"{res['flops']} below the model FLOPs {mf}")
        km = res["kernels_meta"]
        check(km["quantize_ef"] == meas["b1_a_step"] == 1
              and not km["quantize_ef_dyn"] and not km["paged_attention"]
              and not km["flash_attention"],
              f"dryrun {arch}: meta launches {km}, B1 on the card "
              f"{meas['b1_a_step']} a step")
    took = time.perf_counter() - t0
    check(took < DRYRUN_LIMIT_S, f"dryrun: the phase took {took:.1f} s, "
          f"the limit is {DRYRUN_LIMIT_S:.0f}")


# --------------------------------------------------------------------------- #
# the trainer's tensor-parallel 'model' axis
# --------------------------------------------------------------------------- #
# gemma-2b at its published widths (d_model 2048, 8 heads over one KV head
# of 256, d_ff 16384, vocab 256,000, bf16) cut to TP_LAYERS of its 18
# layers (1.49 B parameters): two ranks of a data 1 x model 2 mesh share
# the one card, each holding its half of the training state, so the
# one-process step at the same depth must fit the card too
TP_ARCH, TP_LAYERS, TP_STEPS = "gemma-2b", 4, 5
# the mixers and the encoder-decoder on the same two ranks, at phase
# zoo's depths and batches: (arch, layers, batch, seq, steps, seed)
TP_ZOO = ((ZOO_SSD, ZOO_SSD_LAYERS, LM_BATCH, LM_SEQ, 3, 23),
          (ZOO_RG, ZOO_RG_LAYERS, ZOO_RG_BATCH, LM_SEQ, 3, 29),
          (ZOO_WH, 4, ZOO_WH_BATCH, ZOO_WH_SEQ, 3, 29))
# prefill and decode on the same two ranks: (arch, layers, dtype, decode
# steps, kv layouts), TP_SERVE_ROWS rows of TP_SERVE_PROMPT tokens, once in
# one process and on the ranks under each layout. In bf16 the ranks' peaks
# are held to the dry-run's forecast and their tokens reported; in f32 the
# tokens and the last logits are held to the one process's
TP_SERVE = (("gemma-2b", 18, "bfloat16", 32, ("hd_model", "seq_model")),
            (ZOO_SSD, ZOO_SSD_LAYERS, "bfloat16", 16, ("hd_model",)),
            ("gemma-2b", TP_LAYERS, "float32", 32, ("hd_model", "seq_model")),
            (ZOO_SSD, ZOO_SSD_LAYERS, "float32", 16, ("hd_model",)))
TP_SERVE_ROWS, TP_SERVE_PROMPT, TP_SERVE_SEED = 8, 2048, 41
TP_SERVE_TOL = 1e-4        # rtol and atol, the CPU parity test's in f32
TP_WAIT_S = 600.0          # the ranks' deadline
PROBE_WAIT_S = 90.0


def _spawn_ranks(fn, world, args, wait_s):
    """[fn(rank, init, *args)] over `world` spawned processes sharing the
    card, joined through a file:// store in a fresh directory; every rank
    answers within `wait_s` or the phase fails (and the rest are
    killed)."""
    import multiprocessing
    import queue
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'group')}"
        procs = [ctx.Process(target=_rank_entry, args=(fn, r, init, args, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + wait_s
        try:
            while len(out) < world:
                try:
                    rank, ok, res = q.get(timeout=max(
                        deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise SmokeFailure(f"{world - len(out)} of {world} ranks "
                                       f"did not answer in {wait_s:.0f} s")
                out[rank] = (ok, res)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world)]


def _rank_entry(fn, rank, init, args, q):
    import traceback
    try:
        q.put((rank, True, fn(rank, init, *args)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()[-4000:]))


def tp_nccl_probe(rank, init):
    """One NCCL all_reduce between two ranks of cuda:0: the error it
    raised (None if it ran)."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=init, rank=rank, world_size=2,
            device_id=torch.device("cuda", 0),
            timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return None
    except Exception as e:  # the refusal is the measurement
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_rank(rank, init, backend, runs, serves):
    """Rank `rank` of the data 1 x model 2 mesh on cuda:0, each of `runs`
    in turn (`_tp_train`), then each of `serves` (`_tp_serve`). What the
    rank prints comes back as "log", for the parent to print in rank
    order."""
    import io
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = _tp_rank(rank, init, backend, runs, serves)
    return {"runs": out[0], "serves": out[1], "log": buf.getvalue()}


def _tp_rank(rank, init, backend, runs, serves):
    import torch
    from repro_torch.launch.mesh import ProcessMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as in phase zoo: recurrentgemma-2b's step needs whole segments
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    mesh = ProcessMesh.init(rank, 2, device_type="cuda", local_rank=0,
                            init_method=init, model=2, backend=backend,
                            timeout_s=TP_WAIT_S)
    try:
        return ([_tp_train(mesh, rank, *run) for run in runs],
                [_tp_serve(mesh.device, mesh, *run) for run in serves])
    finally:
        mesh.close()


def _tp_serve(dev, mesh, arch, layers, dtype, steps, kv_layout, rows=None):
    """`arch` at `layers` layers in `dtype`, over the rank's shards of
    `mesh` (None: one process): prefill of TP_SERVE_ROWS x
    TP_SERVE_PROMPT tokens (`rows`, a slice: those rows alone; the cache
    reserving `steps` more positions, in `kv_layout`), then `steps`
    greedy decode steps. Returns the greedy
    tokens (rows x steps + 1), the prefill's and the last step's logits
    in f32, the bytes of the
    cache on the card, and the peak memory and wall time of the prefill
    and of the decode steps (each peak from the state before it)."""
    import dataclasses

    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import build
    cfg = dataclasses.replace(get(arch), num_layers=layers,
                              param_dtype=dtype)
    bundle = build(cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(TP_SERVE_SEED)
    params = bundle.init(generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size,
                           (TP_SERVE_ROWS, TP_SERVE_PROMPT), generator=gen,
                           device=dev)
    if rows is not None:    # a data rank's rows (the fsdp layout)
        tokens = tokens[rows].contiguous()
    free_cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # kv_layout splits the cache over a model axis: one process has none
    kw = {} if mesh is None else {"kv_layout": kv_layout}
    SSD.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, c = bundle.prefill(params, tokens, None,
                               max_len=TP_SERVE_PROMPT + steps, **kw)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre_peak = torch.cuda.max_memory_allocated()
        first = lg.float().cpu().numpy()
        # the device's cache: every leaf but the host-side "pos"
        cache = sum(x.numel() * x.element_size()
                    for p, x in zip(*T.flatten(c))
                    if x is not None and p[-1] != "pos")
        out = [tok]
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            lg, c = bundle.decode_step(params, tok[:, None], c)
            tok = lg.argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    res = {"arch": arch, "layers": layers, "dtype": dtype,
           "kv_layout": kv_layout,
           # numpy: a tensor leaving a spawned rank through its queue
           # would share its storage with a process that is exiting
           "tokens": torch.stack(out, 1).cpu().numpy(),
           "first": first, "last": lg.float().cpu().numpy(),
           "cache": cache, "prefill_peak": pre_peak,
           "decode_peak": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in T.leaves(params)),
           "prefill_s": t1 - t0, "decode_s": t2 - t1,
           "ssd": (SSD.ssd_launches, SSD.ssd_bwd_launches),
           "ssd_layers": ssd_layers(cfg)}
    del params, c, lg, bundle
    free_cuda()
    return res


def _tp_train(mesh, rank, arch, layers, batch, seq, steps, seed):
    """`arch` at `layers` layers over the rank's shards, batch `batch` x
    `seq`: `steps` steps (B1 once a step over the replicated leaves'
    bucket, finite losses), the rank's peak memory, one more step with
    B1's operands held bit for bit to its plain version, and a digest of
    each replicated parameter; the trainer is freed before it returns."""
    import dataclasses
    import hashlib

    import torch
    from repro_torch import checkpoint as CK
    from repro_torch import tree as T
    from repro_torch.configs import DQConfig, get
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.data import lm_batch_iterator
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import build, param_specs
    dev = mesh.device
    cfg = dataclasses.replace(get(arch), num_layers=layers)
    bundle = build(cfg, mesh)
    dq = DQConfig.from_strategy(single_strategy(), optimizer="omd",
                                lr=1e-4, message="update")
    tr = DQGAN(field_fn=bundle.field_fn, dq=dq, mesh=mesh, seed=seed + 1,
               param_specs=param_specs(cfg, mesh, seq))
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = tr.init(bundle.init(generator=gen, device=dev, max_seq=seq))
    batches = lm_batch_iterator(
        batch, seq, cfg.vocab_size, generator=gen, device=dev,
        enc_shape=((cfg.encdec.enc_seq, cfg.d_model) if cfg.is_encdec
                   else None))
    layout = tr._comm(st.params)[0]
    rows = sum(b.size for b in layout.buckets) // 1024
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    SSD.reset_launches()
    # one step a call, as phase lm train takes them: a caller holding
    # the state it passed in would keep the first state alive beside
    # every later step's
    times, losses = [], []
    for _ in range(steps):
        st, t, l, _ = lm_steps(tr, st, batches, 1, f"tp {arch} rank {rank}")
        times += t
        losses += l
    launches = Q.launches
    ssd = (SSD.ssd_launches, SSD.ssd_bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    st = lm_check_b1_step(tr, st, batches, rows, f"tp {arch} rank {rank}")
    shards = tr.state_shards(st)
    digests = {n: hashlib.sha256(x.detach().cpu().view(torch.uint8)
                                 .numpy().tobytes()).hexdigest()
               for n, x in CK._paths(st.params)
               if f"params/{n}" not in shards.leaves}
    out = {"arch": arch, "launches": launches, "ssd": ssd,
           "ssd_layers": ssd_layers(cfg), "peak": peak,
           "times": times, "losses": losses, "rows": rows,
           "skipped": len(layout.skipped), "digests": digests,
           "backend": mesh.backend,
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in T.leaves(st.params))}
    del tr, st, batches, bundle
    free_cuda()
    return out


def _tp_report(i, r, steps, one_peak, gpu):
    """Rank i's record of one arch: its checks and its line."""
    check(r["launches"] == steps, f"tp {r['arch']} rank {i}: B1 launched "
          f"{r['launches']} times in {steps} steps")
    check_ssd_path(f"tp {r['arch']} model 2 rank {i}", r["ssd"],
                   r["ssd_layers"], steps)
    print(f"# tp (c) {r['arch']} rank {i}: {r['param_bytes']} parameter "
          f"bytes, {r['skipped']} sharded leaves on the per-tensor path, B1 "
          f"{r['launches']} in {steps} steps over {r['rows']} rows, losses "
          f"{[round(x, 4) for x in r['losses']]}, peak {gib(r['peak']):.2f} "
          f"GiB ({r['peak'] / one_peak:.3f} of the one-process peak "
          f"{gib(one_peak):.2f} GiB), ssd_chunked {list(r['ssd'])} "
          f"(forward, backward) calls, median step "
          f"{statistics.median(r['times'][1:]) * 1e3:.3f} ms over "
          f"{r['backend']} (two ranks share the card: not a tensor-parallel "
          f"speed); gpu {gpu}")


def _tp_forecast(i, r, fc, strict):
    """The dry-run's forecast of rank i's peak and parameter bytes: the
    bytes always equal, the peak within 0.85-1.15 where `strict`."""
    ratio = fc["peak_bytes"] / r["peak"]
    print(f"# tp (d) {r['arch']} rank {i}: forecast peak "
          f"{gib(fc['peak_bytes']):.2f} GiB against {gib(r['peak']):.2f} "
          f"measured (ratio {ratio:.3f}{'' if strict else ', reported'}); "
          f"forecast parameter bytes {fc['param_bytes_per_rank']}; "
          f"model-group collectives {fc['collectives_model']}")
    if strict:
        check(0.85 <= ratio <= 1.15, f"tp {r['arch']} rank {i}: forecast "
              f"peak {fc['peak_bytes']} against {r['peak']} measured")
    check(fc["param_bytes_per_rank"] == r["param_bytes"],
          f"tp {r['arch']} rank {i}: forecast parameter bytes "
          f"{fc['param_bytes_per_rank']} against {r['param_bytes']}")


def phase_tp(dev, gpu, zoo_peaks):
    """The trainer's 'model' axis on the card, omd, qsgd8_block1024 over
    uniform 4 MiB buckets:
    (a) NCCL with two ranks on the one card (expected refused: NCCL takes
        one rank a device); when it refuses, the ranks' groups are gloo
        over the CUDA tensors, which stay on the card;
    (b) gemma-2b at its published widths, TP_LAYERS of 18 layers, batch
        LM_BATCH x LM_SEQ, the one-process step at the same depth,
        TP_STEPS steps: its peak memory past the initial state;
    (c) two spawned ranks of a data 1 x model 2 mesh, that gemma-2b then
        the mixers and the encoder-decoder (TP_ZOO: mamba2-1.3b,
        recurrentgemma-2b and whisper-tiny at phase zoo's depths and
        batches, whose one-process peaks are phase zoo's `zoo_peaks`):
        each rank holds its shards only (the sharded leaves off the
        buckets, on the per-tensor path), B1 once a step over the
        replicated leaves' bucket, finite losses, the rank's peak
        against the one process's (expected ratios in PERF.md), one
        step's B1 operands bit-equal to its plain version, the
        replicated parameters bit-identical on the two ranks; the median
        step on the named backend is not a tensor-parallel speed (two
        ranks share the card, and gloo stages through the host);
    (d) the dry-run's forecast of one rank (`launch.dryrun`'s trace at the
        same mesh, on the meta device): its parameter bytes equal to the
        rank's, its peak within 0.85-1.15 of the measured for gemma-2b
        and mamba2-1.3b (reported for the other two);
    (e) prefill and decode (TP_SERVE): gemma-2b whole (18 layers) and
        mamba2-1.3b (48) in bf16, TP_SERVE_ROWS x TP_SERVE_PROMPT then
        32 and 16 greedy steps, once in one process and then on the same
        two ranks, gemma-2b's cache in each kv layout: each rank's cache
        (K/V, or the mixers' state) exactly half of the one process's,
        the two ranks' tokens equal, the share of the one process's
        tokens reported (bf16 near-ties part them), and each rank's
        prefill and decode peaks within 0.85-1.15 of the dry-run's
        forecast of a rank at the same mesh, rows and layout, with the
        prefill logits' max |diff| from the one process's beside its
        top-two gaps and the step at which each row first parts; then
        gemma-2b at TP_LAYERS and mamba2-1.3b at all 48 layers in f32,
        where the ranks' greedy tokens equal the one process's at every
        step and their last logits agree within TP_SERVE_TOL.
    Returns B1's launches on the path (each rank's, by arch) and the
    ranks' backend."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import dryrun

    # ---- (a) NCCL with two ranks on one device ---------------------------- #
    probe = _spawn_ranks(tp_nccl_probe, 2, (), PROBE_WAIT_S)
    errs = [res for ok, res in probe]
    check(all(ok for ok, _ in probe), f"tp: the NCCL probe failed: {errs}")
    backend = "gloo" if any(errs) else "nccl"
    said = ("refused: " + "; ".join(e for e in errs if e) if any(errs)
            else "ran")
    print(f"# tp (a): NCCL with two ranks on cuda:0: {said}; the phase's "
          f"groups: {backend}")

    # ---- (b) one process, the same depth --------------------------------- #
    free_cuda()
    tr, st, batches, cfg, _ = lm_trainer(dev, TP_ARCH, TP_LAYERS, 7)
    n_params = sum(x.numel() for x in T.leaves(st.params))
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    times1 = []
    for _ in range(TP_STEPS):     # one step a call (see _tp_train)
        st, t, _, _ = lm_steps(tr, st, batches, 1, "tp one process")
        times1 += t
    peak1 = torch.cuda.max_memory_allocated()
    print(f"# tp (b): {TP_ARCH} {TP_LAYERS} of 18 layers ({n_params} "
          f"parameters, {cfg.param_dtype}), one process, batch {LM_BATCH} x "
          f"{LM_SEQ}: peak {gib(peak1):.2f} GiB, median step "
          f"{statistics.median(times1[1:]) * 1e3:.3f} ms; gpu {gpu}")
    del tr, st, batches
    free_cuda()

    # ---- (e) prefill and decode in one process ---------------------------- #
    t0 = time.perf_counter()
    one = {run[:3]: _tp_serve(dev, None, *run[:4], "hd_model")
           for run in TP_SERVE}
    serves = [run[:4] + (kv,) for run in TP_SERVE for kv in run[4]]
    print(f"# tp (e): prefill and decode in one process took "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (c) two ranks, data 1 x model 2 --------------------------------- #
    t0 = time.perf_counter()
    runs = ((TP_ARCH, TP_LAYERS, LM_BATCH, LM_SEQ, TP_STEPS, 7),) + TP_ZOO
    res = _spawn_ranks(tp_rank, 2, (backend, runs, serves), TP_WAIT_S)
    bad = [r for ok, r in res if not ok]
    check(not bad, "tp: a rank failed:\n" + "\n".join(bad))
    for _, r in res:
        print(r["log"], end="")
    peaks = {TP_ARCH: peak1, **zoo_peaks}
    launches = {}
    for (arch, layers, batch, seq, steps, _), *ranks in zip(
            runs, *[r["runs"] for _, r in res]):
        for i, r in enumerate(ranks):
            _tp_report(i, r, steps, peaks[arch], gpu)
            launches[f"tp {arch} model 2 rank {i}"] = r["launches"]
        check(ranks[0]["digests"] == ranks[1]["digests"]
              and ranks[0]["digests"], f"tp {arch}: the replicated "
              f"parameters differ across the model ranks")
        check(ranks[0]["losses"] == ranks[1]["losses"],
              f"tp {arch}: the ranks' losses differ: {ranks[0]['losses']} "
              f"{ranks[1]['losses']}")
        print(f"# tp (c) {arch}: {len(ranks[0]['digests'])} replicated "
              f"parameters bit-identical on both ranks after {steps + 1} "
              f"steps")

        # ---- (d) the dry-run's forecast of a rank ------------------------ #
        cfg = dataclasses.replace(configs.get(arch), num_layers=layers)
        shape = configs.InputShape(f"{arch}-{layers}", seq, batch, "train")
        fc = dryrun.trace_train(cfg, shape, single_strategy(), ranks=2,
                                model=2, optimizer="omd", lr=1e-4,
                                message="update")
        for i, r in enumerate(ranks):
            _tp_forecast(i, r, fc, arch in (TP_ARCH, ZOO_SSD))
    print(f"# tp (c): the ranks took {time.perf_counter() - t0:.1f} s; gpu "
          f"{gpu}")
    t0 = time.perf_counter()
    for run, *ranks in zip(serves, *[r["serves"] for _, r in res]):
        _tp_serve_report(one[run[:3]], ranks, gpu)
        f32 = one.get(run[:2] + ("float32",))
        if run[2] == "bfloat16" and f32 is not None:
            # bf16's own error at this depth: the same seed's f32 run
            # (weights unrounded) against the one process's and a rank's
            # bf16 prefill logits
            d1, d2 = (float(np.abs(x["first"] - f32["first"]).max())
                      for x in (one[run[:3]], ranks[0]))
            print(f"# tp (e) {run[0]} {run[1]} layers {run[4]}: bf16 "
                  f"prefill logits against the f32 run's, max |diff| one "
                  f"process {d1:.3e}, rank 0 {d2:.3e}")
    print(f"# tp (e): the serving checks and forecasts took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches, backend


def _tp_serve_report(one, ranks, gpu):
    """One serving run of the two ranks against the one process's: the
    cache half, the ranks' tokens equal, and in bf16 the token share and
    the peaks against the dry-run's forecast, in f32 the tokens and last
    logits (phase tp (e))."""
    import dataclasses

    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import dryrun
    arch, layers, dtype, kv = (ranks[0][k] for k in ("arch", "layers",
                                                     "dtype", "kv_layout"))
    label = f"tp (e) {arch} {layers} layers {dtype} {kv}"
    steps = one["tokens"].shape[1] - 1
    check_ssd_path(f"{label} one process", one["ssd"], one["ssd_layers"])
    for i, r in enumerate(ranks):
        check_ssd_path(f"{label} rank {i}", r["ssd"], r["ssd_layers"])
    check(np.array_equal(ranks[0]["tokens"], ranks[1]["tokens"]),
          f"{label}: the two ranks' greedy tokens differ")
    same = float((ranks[0]["tokens"] == one["tokens"]).mean())

    def rows(a):
        return np.array2string(a, max_line_width=10 ** 6, formatter={
            "float_kind": lambda x: f"{x:.3e}"})

    # whether a parting is a near tie: the prefill's logits apart by more
    # than the one process's gap between its top two tokens
    diff = np.abs(ranks[0]["first"] - one["first"]).max(-1)
    top2 = np.sort(one["first"], -1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    parted = ranks[0]["tokens"] != one["tokens"]
    at = np.where(parted.any(1), parted.argmax(1), -1)
    print(f"# {label}: prefill logits max |diff| {diff.max():.3e} (max "
          f"|logit| {np.abs(one['first']).max():.3f}); per row |diff| "
          f"{rows(diff)}, the one process's top-two gap {rows(gap)}; each row "
          f"first parts at step {at.tolist()} of 0-{steps} (-1: never)")
    for i, r in enumerate(ranks):
        check(2 * r["cache"] == one["cache"], f"{label} rank {i}: cache "
              f"{r['cache']} bytes against the one process's "
              f"{one['cache']}")
        print(f"# {label} rank {i}: cache {r['cache']} bytes (one process "
              f"{one['cache']}: {r['cache'] / one['cache']:.4f}); "
              f"parameters {r['param_bytes']} (one process "
              f"{one['param_bytes']}); prefill {TP_SERVE_ROWS} x "
              f"{TP_SERVE_PROMPT} {r['prefill_s']:.3f} s (one process "
              f"{one['prefill_s']:.3f}), {steps} decode steps "
              f"{r['decode_s']:.3f} s (one process {one['decode_s']:.3f}; "
              f"two ranks share the card over gloo); peaks prefill "
              f"{gib(r['prefill_peak']):.3f} GiB, decode "
              f"{gib(r['decode_peak']):.3f} GiB (one process "
              f"{gib(one['prefill_peak']):.3f}, "
              f"{gib(one['decode_peak']):.3f}); greedy tokens equal to the "
              f"one process's: {same:.4f} of {one['tokens'].size}; gpu "
              f"{gpu}")
    if dtype == "float32":
        check(same == 1.0, f"{label}: greedy tokens equal to the one "
              f"process's at {same:.4f} of the steps")
        err = np.abs(ranks[0]["last"] - one["last"])
        bound = TP_SERVE_TOL + TP_SERVE_TOL * np.abs(one["last"])
        print(f"# {label}: last logits max |diff| {err.max():.3e} (max "
              f"|logit| {np.abs(one['last']).max():.3f}), "
              f"{int((err > bound).sum())} over rtol = atol = "
              f"{TP_SERVE_TOL:g}")
        check(bool((err <= bound).all()), f"{label}: last logits differ "
              f"from the one process's beyond rtol = atol = {TP_SERVE_TOL}")
        return
    cfg = dataclasses.replace(configs.get(arch), num_layers=layers,
                              param_dtype=dtype)
    shape = configs.InputShape(f"{arch}-{layers}", TP_SERVE_PROMPT,
                               TP_SERVE_ROWS, "prefill")
    fc = {"prefill": dryrun.trace_prefill(
              cfg, shape, TP_SERVE_ROWS, ranks=2, model=2, kv_layout=kv,
              max_len=TP_SERVE_PROMPT + steps),
          "decode": dryrun.trace_decode(
              cfg, dataclasses.replace(shape, seq_len=TP_SERVE_PROMPT + steps,
                                       kind="decode"),
              TP_SERVE_ROWS, ranks=2, model=2, kv_layout=kv)}
    for i, r in enumerate(ranks):
        for k, f in fc.items():
            ratio = f["peak_bytes"] / r[f"{k}_peak"]
            print(f"# {label} rank {i}: forecast {k} peak "
                  f"{gib(f['peak_bytes']):.3f} GiB against "
                  f"{gib(r[f'{k}_peak']):.3f} measured (ratio {ratio:.3f}); "
                  f"forecast cache {f['cache_bytes_per_rank']} bytes, "
                  f"parameters {f['param_bytes_per_rank']}")
            check(0.85 <= ratio <= 1.15, f"{label} rank {i}: forecast {k} "
                  f"peak {f['peak_bytes']} against {r[f'{k}_peak']}")
        check(fc["decode"]["param_bytes_per_rank"] == r["param_bytes"],
              f"{label} rank {i}: forecast parameter bytes "
              f"{fc['decode']['param_bytes_per_rank']} against "
              f"{r['param_bytes']}")


# --------------------------------------------------------------------------- #
# the fsdp parameter layout (the reference's Mode B)
# --------------------------------------------------------------------------- #
# yi-34b at its published widths (d_model 7168, 56 heads over 8 KV heads of
# 128, d_ff 20480, vocab 64,000) cut to LAYOUT_LAYERS of its 60 layers
# (1.48 B parameters): four ranks of a data 2 x model 2 Mode-B mesh share
# the one card, one worker, each rank holding its shard of every
# parameter; the one-process step at the same depth must fit the card too
LAYOUT_ARCH, LAYOUT_LAYERS, LAYOUT_STEPS, LAYOUT_SEED = "yi-34b", 1, 3, 53
LAYOUT_DATA, LAYOUT_MODEL = 2, 2
LAYOUT_RANKS = LAYOUT_DATA * LAYOUT_MODEL
LAYOUT_SERVE_STEPS = 16
LAYOUT_LOSS_RTOL = 1e-5   # the step-0 loss in f32, the CPU parity test's
# (b)'s quantizer: B1 at 7 levels over the same buckets. At 127 levels the
# card's float32 reorders (a data rank's half batch, a model rank's half
# of each contraction) moved the codes of 1.03e-3 of a rank's residuals
# (PERF.md §6), past the parity rule's 1e-3 budget; a code flips with
# probability ~ levels x the message's relative error. The witness at
# 127 levels: the one process against itself with its batch in two
# halves whose fields are summed, the data ranks' reorder alone
LAYOUT_F32_COMPRESSOR = "qsgd4_block1024"
LAYOUT_WITNESS_COMPRESSOR = "qsgd8_block1024"


def layout_strategy(compressor="qsgd8_block1024"):
    """Phase layout's strategy: `compressor` over uniform 4 MiB buckets,
    float32 residuals (a bf16 residual rounds a float32 reorder of the
    message into a flipped element, which `repro_torch.parity` counts
    against the f32 comparison)."""
    from repro_torch.strategy import Compression, Strategy
    return Strategy(compression=Compression(compressor=compressor,
                                            plan="uniform"))


def _layout_specs():
    """The full parameters' spec tree at the phase's Mode-B mesh (one
    process takes it too, for the same buckets and draws)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch.mesh import meta_mesh
    from repro_torch.models import param_specs
    cfg = dataclasses.replace(get(LAYOUT_ARCH), num_layers=LAYOUT_LAYERS)
    return param_specs(cfg, meta_mesh(LAYOUT_RANKS, 0, model=LAYOUT_MODEL,
                                      layout="fsdp"), LM_SEQ)


def _data_digests(st, shards):
    """{name: (sha256, cut over 'model')} of each parameter and residual
    e1 of the state `st` that no data rank cuts (by `shards`, the
    trainer's `state_shards`): the replicated leaves, and the shards of
    those cut over 'model' alone. Each is one value across an fsdp
    group."""
    import hashlib

    import torch
    from repro_torch import checkpoint as CK
    return {n: (hashlib.sha256(x.detach().contiguous().reshape(-1).cpu()
                               .view(torch.uint8).numpy()).hexdigest(),
                n in shards.leaves)
            for n, x in CK._paths(st)
            if (n.startswith("params/") or n.endswith("/e1"))
            and (n not in shards.leaves
                 or shards.leaves[n].data_axis is None)}


def _layout_fsdp_groups(ranks, key, label):
    """Each fsdp group's ranks (one model index, every data index) hold
    the same bits of every parameter and residual that no data rank cuts
    (`_data_digests` of each rank's `key` run)."""
    groups = {}
    for r in ranks:
        groups.setdefault(r["coords"][1], []).append(r[key]["data_digests"])
    for m, g in sorted(groups.items()):
        bad = sorted(n for d in g[1:] for n in set(g[0]) | set(d)
                     if d.get(n) != g[0].get(n))
        check(len(g) == LAYOUT_DATA and g[0] and not bad, f"{label}: the "
              f"leaves no data rank cuts differ across the data ranks of "
              f"model index {m}: {bad[:8]}")
    d = g[0]
    print(f"# {label}: {len(d)} parameters and residuals that no data rank "
          f"cuts ({sum(c for _, c in d.values())} of them model shards, e.g. "
          f"{sorted(n for n, (_, c) in d.items() if c)[:3]}) bit-identical "
          f"across each fsdp group ({LAYOUT_DATA} data ranks of one model "
          f"index)")


def _in_halves(field_fn):
    """`field_fn` over a batch's two halves of rows, the two fields and
    losses averaged: the data ranks' reorder in one process."""
    from repro_torch import tree as T

    def field(params, batch, **kw):
        n = next(iter(batch.values())).shape[0] // 2
        g, met = field_fn(params, {k: v[:n] for k, v in batch.items()}, **kw)
        g2, met2 = field_fn(params, {k: v[n:] for k, v in batch.items()},
                            **kw)
        g = T.tree_map(lambda a, b: a.add_(b).div_(2), g, g2)
        return g, {"loss": (met["loss"] + met2["loss"]) / 2}
    return field


def _layout_train(dev, mesh, dtype, steps, check_b1, ref_dir=None,
                  compressor="qsgd8_block1024", halves=False):
    """yi-34b at LAYOUT_LAYERS layers in `dtype` over the rank's Mode-B
    shards of `mesh` (None: one process with the same specs), batch
    LM_BATCH x LM_SEQ from one seeded generator: `steps` steps (B1 once a
    step, finite losses), the peak past the initial state, then with
    `check_b1` one more step with B1's operands held bit for bit to its
    plain version and a digest of each replicated parameter; else, at
    `ref_dir`, one process writes its parameters and residuals e1 there
    (a .npy a leaf) and a rank, or the one process with `halves` (its
    field over the batch's two halves, `_in_halves`), holds its own
    against their slices (`_layout_agreement`). A rank also digests each
    parameter and residual that no data rank cuts (`_data_digests`)."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch import tree as T
    from repro_torch.configs import DQConfig, get
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.data import lm_batch_iterator
    from repro_torch.kernels import quantize as Q
    from repro_torch.models import build
    cfg = dataclasses.replace(get(LAYOUT_ARCH), num_layers=LAYOUT_LAYERS,
                              param_dtype=dtype)
    bundle = build(cfg, mesh)
    dq = DQConfig.from_strategy(layout_strategy(compressor),
                                optimizer="omd", lr=1e-4,
                                message="update")
    field_fn = _in_halves(bundle.field_fn) if halves else bundle.field_fn
    tr = DQGAN(field_fn=field_fn, dq=dq, device=dev, mesh=mesh,
               seed=LAYOUT_SEED + 1, param_specs=_layout_specs())
    gen = torch.Generator(device=dev).manual_seed(LAYOUT_SEED)
    st = tr.init(bundle.init(generator=gen, device=dev, max_seq=LM_SEQ))
    batches = lm_batch_iterator(LM_BATCH, LM_SEQ, cfg.vocab_size,
                                generator=gen, device=dev)
    layout = tr._comm(st.params)[0]
    rows = sum(b.size for b in layout.buckets) // 1024
    label = f"layout {dtype} " + ("one process" if mesh is None
                                  else f"rank {mesh.rank}")
    label += " in halves" if halves else ""
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_launches()
    times, losses = [], []
    for _ in range(steps):      # one step a call (see _tp_train)
        st, t, l, _ = lm_steps(tr, st, batches, 1, label)
        times += t
        losses += l
    launches = Q.launches
    peak = torch.cuda.max_memory_allocated()
    out = {"launches": launches, "peak": peak, "times": times,
           "losses": losses, "rows": rows, "skipped": len(layout.skipped),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in T.leaves(st.params))}
    if check_b1:
        st = lm_check_b1_step(tr, st, batches, rows, label)
        shards = tr.state_shards(st)
        out["digests"] = {
            n: hashlib.sha256(x.detach().cpu().view(torch.uint8).numpy()
                              .tobytes()).hexdigest()
            for n, x in CK._paths(st.params)
            if shards is None or f"params/{n}" not in shards.leaves}
    else:
        named = [(n, x) for n, x in CK._paths(st)
                 if n.startswith("params/") or n.endswith("/e1")]
        if mesh is None and not halves:
            for i, (n, x) in enumerate(named):
                np.save(os.path.join(ref_dir, f"{i}.npy"),
                        x.detach().float().cpu().numpy())
            with open(os.path.join(ref_dir, "names.json"), "w") as f:
                json.dump([n for n, _ in named], f)
        else:
            out["agreement"] = _layout_agreement(named, ref_dir, mesh)
        del named
    if mesh is not None:
        out["data_digests"] = _data_digests(st, tr.state_shards(st))
    del tr, st, batches, bundle
    free_cuda()
    return out


def layout_rank(rank, init, backend, serves, ref_dir):
    """Rank `rank` of the phase's Mode-B mesh on cuda:0: (a) the bf16
    steps, (b) the f32 steps, (c) each of `serves` on its data index's
    rows. What the rank prints comes back as "log"."""
    import io

    import torch
    from repro_torch.launch.mesh import ProcessMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    buf = io.StringIO()
    with redirect_stdout(buf):
        mesh = ProcessMesh.init(rank, LAYOUT_RANKS, device_type="cuda",
                                local_rank=0, init_method=init,
                                model=LAYOUT_MODEL, layout="fsdp",
                                backend=backend, timeout_s=TP_WAIT_S)
        try:
            n = TP_SERVE_ROWS // mesh.data
            rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
            out = {"coords": (mesh.data_index, mesh.model_index),
                   "walls": {}}
            for key, fn in (
                    ("bf16", lambda: _layout_train(
                        mesh.device, mesh, "bfloat16", LAYOUT_STEPS, True)),
                    ("f32", lambda: _layout_train(
                        mesh.device, mesh, "float32", LAYOUT_STEPS, False,
                        ref_dir, LAYOUT_F32_COMPRESSOR)),
                    ("serves", lambda: [_tp_serve(mesh.device, mesh, *run,
                                                  rows=rows)
                                        for run in serves])):
                t0 = time.perf_counter()
                out[key] = fn()
                out["walls"][key] = time.perf_counter() - t0
        finally:
            mesh.close()
    out["log"] = buf.getvalue()
    return out


def _layout_agreement(named, ref_dir, mesh):
    """(b) on a rank: its shards of the f32 parameters and residuals
    (`named`, [(name, tensor)]) against the one process's at `ref_dir`
    cut the same way (mesh None: whole; each read through a memory map), by
    `repro_torch.parity`'s rule (one worker); its numbers, problems and
    the leaves with the most flipped residuals."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.parallel import sharding as shd
    from repro_torch.parity import named_agreement
    specs = {"/".join(map(str, p)): sp
             for p, sp in zip(*T.flatten(_layout_specs()))}
    with open(os.path.join(ref_dir, "names.json")) as f:
        names = json.load(f)
    cut = (dict(index=0, size=1, data_index=0, data_size=1) if mesh is None
           else shd.rank_cut(mesh))
    got = dict(named)
    ref = {}
    for i, name in enumerate(names):
        key, lead = name.split("/", 1)[1], 0
        if name.startswith("ef/"):          # (1, *leaf) under the worker
            key, lead = key.removeprefix("leaf/").removesuffix("/e1"), 1
        full = torch.from_numpy(np.load(os.path.join(ref_dir, f"{i}.npy"),
                                        mmap_mode="r"))
        ref[name] = np.ascontiguousarray(shd.shard_of(
            full, (None,) * lead + tuple(specs[key]), **cut).numpy())
    got = {k: got[k].detach().float().cpu().numpy() for k in ref}
    ag = named_agreement(ref, got, 1, 1)
    flips = sorted(((float((np.abs(ref[k] - got[k]) > 1e-3 * ag.emax).sum()),
                     got[k].size, k) for k in ref if k.endswith("/e1")),
                   reverse=True)
    return {"d_params": ag.d_params, "d_invariant": ag.d_invariant,
            "atol": ag.atol, "emax": ag.emax, "problems": ag.problems,
            "flipped": sum(c for c, _, _ in flips)
            / sum(n for _, n, _ in flips),
            "flips": [(k, int(c), n) for c, n, k in flips[:4]]}


def phase_layout(dev, gpu, backend):
    """The reference's fsdp parameter layout (Mode B) on the card: yi-34b
    at its published widths cut to LAYOUT_LAYERS layers, one worker over
    LAYOUT_RANKS spawned ranks of a data LAYOUT_DATA x model
    LAYOUT_MODEL Mode-B mesh sharing the card over `backend` (phase tp's
    probe: gloo over CUDA tensors where NCCL refuses two ranks of one
    device), omd, `layout_strategy()`, batch LM_BATCH x LM_SEQ; one
    process at the same depth first:
    (a) bf16, LAYOUT_STEPS steps: each rank's parameter bytes the JAX
        layout's per-device bytes at the mesh, finite losses, B1 once a
        step over the replicated leaves' bucket and bit-equal to its
        plain version on one more step's operands, the replicated
        parameters bit-identical across the ranks and each parameter and
        residual that no data rank cuts across each fsdp group, each
        rank's peak
        within 0.85-1.15 of the dry-run's forecast of a rank at the same
        mesh, rows and layout, and its share of the one process's;
    (b) f32, LAYOUT_STEPS steps (the same sequence: the state, not the
        activations, sets the peak), B1 at LAYOUT_F32_COMPRESSOR's
        levels: each rank's shards of the parameters and residuals
        against the one process's by `repro_torch.parity`'s rule (its
        flipped residuals reported by leaf), the step-0 loss within
        LAYOUT_LOSS_RTOL, each parameter and residual that no data rank
        cuts bit-identical across each fsdp group; and its witness at
        LAYOUT_WITNESS_COMPRESSOR's 127 levels, reported: the one process
        with its batch in halves against it whole (the data ranks'
        float32 reorder without Mode B), the residuals it flips;
    (c) prefill of TP_SERVE_ROWS x TP_SERVE_PROMPT (each data rank its
        rows) and LAYOUT_SERVE_STEPS greedy decode steps, the one process
        first: in bf16 each rank's prefill and decode peaks within
        0.85-1.15 of the forecast and the share of the one process's
        tokens reported, in f32 every greedy token equal and the last
        logits within rtol = atol = TP_SERVE_TOL.
    Returns B1's launches on the path (each rank's)."""
    import dataclasses

    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    arch, layers = LAYOUT_ARCH, LAYOUT_LAYERS
    mesh = {"data": LAYOUT_DATA, "model": LAYOUT_MODEL}

    # ---- one process, the same depth and specs --------------------------- #
    import tempfile
    ref = tempfile.TemporaryDirectory()     # the f32 state, for the ranks
    one = {"bfloat16": _layout_train(dev, None, "bfloat16", LAYOUT_STEPS,
                                     True),
           "float32": _layout_train(dev, None, "float32", LAYOUT_STEPS,
                                    False, ref.name, LAYOUT_F32_COMPRESSOR)}
    serves = [(arch, layers, dt, LAYOUT_SERVE_STEPS, "hd_model")
              for dt in ("bfloat16", "float32")]
    one_serve = {run[2]: _tp_serve(dev, None, *run) for run in serves}
    for dt, o in one.items():
        print(f"# layout one process {arch} {layers} of 60 layers {dt}: "
              f"{o['param_bytes']} parameter bytes, peak "
              f"{gib(o['peak']):.2f} GiB, losses "
              f"{[round(x, 5) for x in o['losses']]}, median step "
              f"{statistics.median(o['times'][1:]) * 1e3:.1f} ms; gpu {gpu}")
    print(f"# layout: the one process took "
          f"{time.perf_counter() - t_phase:.1f} s")

    # ---- (b)'s witness at 127 levels: the one process against itself with
    # its batch in halves (the data ranks' reorder, without Mode B) ------ #
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wdir:
        _layout_train(dev, None, "float32", LAYOUT_STEPS, False, wdir,
                      LAYOUT_WITNESS_COMPRESSOR)
        w = _layout_train(dev, None, "float32", LAYOUT_STEPS, False, wdir,
                          LAYOUT_WITNESS_COMPRESSOR, halves=True)["agreement"]
    free_cuda()
    print(f"# layout (b) witness {arch} f32 {LAYOUT_WITNESS_COMPRESSOR}: the "
          f"one process with its batch in halves against it whole after "
          f"{LAYOUT_STEPS} steps: {w['flipped']:.3e} of the residuals "
          f"flipped (the parity rule's budget 1e-3), by leaf (count of "
          f"elements) {w['flips']}; parameters max |diff| "
          f"{w['d_params']:.3e}, invariant part {w['d_invariant']:.3e}, one "
          f"quantization step {w['emax']:.3e}; {time.perf_counter() - t0:.1f}"
          f" s; gpu {gpu}")

    # ---- the ranks -------------------------------------------------------- #
    t0 = time.perf_counter()
    try:
        res = _spawn_ranks(layout_rank, LAYOUT_RANKS,
                           (backend, serves, ref.name), TP_WAIT_S)
    finally:
        ref.cleanup()
    bad = [r for ok, r in res if not ok]
    check(not bad, "layout: a rank failed:\n" + "\n".join(bad))
    ranks = [r for _, r in res]
    for r in ranks:
        print(r["log"], end="")
    print(f"# layout: the {LAYOUT_RANKS} ranks ({backend}) took "
          f"{time.perf_counter() - t0:.1f} s; rank 0's walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in ranks[0]["walls"].items())
          + f"; its f32 steps "
          f"{[round(x, 2) for x in ranks[0]['f32']['times']]} s")

    # ---- (a) bf16 --------------------------------------------------------- #
    cfg = dataclasses.replace(configs.get(arch), num_layers=layers,
                              param_dtype="bfloat16")
    want_bytes = dryrun.param_bytes_per_device(cfg, "fsdp", mesh,
                                               LM_SEQ)["bytes"]
    shape = configs.InputShape(f"{arch}-{layers}", LM_SEQ, LM_BATCH, "train")
    fc = dryrun.trace_train(cfg, shape, layout_strategy(),
                            ranks=LAYOUT_RANKS, model=LAYOUT_MODEL,
                            optimizer="omd", lr=1e-4, message="update",
                            layout="fsdp")
    launches = {}
    for i, r in enumerate(ranks):
        a = r["bf16"]
        label = f"layout (a) {arch} bf16 rank {i} {r['coords']}"
        check(a["launches"] == LAYOUT_STEPS, f"{label}: B1 launched "
              f"{a['launches']} times in {LAYOUT_STEPS} steps")
        check(a["param_bytes"] == want_bytes == fc["param_bytes_per_rank"],
              f"{label}: {a['param_bytes']} parameter bytes, the JAX "
              f"layout's {want_bytes}, the forecast's "
              f"{fc['param_bytes_per_rank']}")
        ratio = fc["peak_bytes"] / a["peak"]
        print(f"# {label}: {a['param_bytes']} parameter bytes (the JAX "
              f"fsdp layout's per-device bytes at (2, 2): {want_bytes}; one "
              f"process {one['bfloat16']['param_bytes']}), {a['skipped']} "
              f"sharded leaves on the per-tensor path, B1 {a['launches']} "
              f"in {LAYOUT_STEPS} steps over {a['rows']} rows, losses "
              f"{[round(x, 5) for x in a['losses']]}, peak "
              f"{gib(a['peak']):.2f} GiB ({a['peak'] / one['bfloat16']['peak']:.3f} "
              f"of the one process's {gib(one['bfloat16']['peak']):.2f} "
              f"GiB), forecast {gib(fc['peak_bytes']):.2f} GiB (forecast "
              f"over measured {ratio:.3f}), median step "
              f"{statistics.median(a['times'][1:]) * 1e3:.1f} ms over "
              f"{backend} (four ranks share the card: not an fsdp speed); "
              f"gpu {gpu}")
        check(0.85 <= ratio <= 1.15, f"{label}: forecast peak "
              f"{fc['peak_bytes']} against {a['peak']} measured")
        launches[f"layout {arch} fsdp rank {i}"] = a["launches"]
    d0 = ranks[0]["bf16"]["digests"]
    check(d0 and all(r["bf16"]["digests"] == d0 for r in ranks),
          "layout (a): the replicated parameters differ across the ranks")
    check(all(r["bf16"]["losses"] == ranks[0]["bf16"]["losses"]
              for r in ranks), "layout (a): the ranks' losses differ")
    print(f"# layout (a): {len(d0)} replicated parameters bit-identical on "
          f"the {LAYOUT_RANKS} ranks after {LAYOUT_STEPS + 1} steps; "
          f"fsdp-group collectives of a rank's step (forecast) "
          f"{fc['collectives_fsdp']}")
    _layout_fsdp_groups(ranks, "bf16", "layout (a)")

    # ---- (b) f32 ---------------------------------------------------------- #
    l0 = one["float32"]["losses"][0]
    for i, r in enumerate(ranks):
        b = r["f32"]
        ag = b["agreement"]
        label = (f"layout (b) {arch} f32 {LAYOUT_F32_COMPRESSOR} rank {i} "
                 f"{r['coords']}")
        check(b["launches"] == LAYOUT_STEPS, f"{label}: B1 launched "
              f"{b['launches']} times")
        print(f"# {label}: after {LAYOUT_STEPS} steps against the one "
              f"process's state cut to the rank: parameters max |diff| "
              f"{ag['d_params']:.3e}, invariant part {ag['d_invariant']:.3e}"
              f" (float32 bound {ag['atol']:.3e}), one quantization step "
              f"{ag['emax']:.3e}; {ag['flipped']:.3e} of the residuals "
              f"flipped, by leaf (count of elements) {ag['flips']}; losses "
              f"{b['losses']} (one process {one['float32']['losses']}), peak {gib(b['peak']):.2f} GiB "
              f"(one process {gib(one['float32']['peak']):.2f}); gpu {gpu}")
    for i, r in enumerate(ranks):
        b, ag = r["f32"], r["f32"]["agreement"]
        label = f"layout (b) {arch} f32 rank {i} {r['coords']}"
        check(not ag["problems"], f"{label}: {ag['problems']}")
        check(abs(b["losses"][0] - l0) <= LAYOUT_LOSS_RTOL * abs(l0),
              f"{label}: step-0 loss {b['losses'][0]} against {l0}")
        launches[f"layout {arch} fsdp f32 rank {i}"] = b["launches"]
    _layout_fsdp_groups(ranks, "f32", "layout (b)")

    # ---- (c) prefill and decode ------------------------------------------ #
    n = TP_SERVE_ROWS // LAYOUT_DATA
    for k, run in enumerate(serves):
        dt = run[2]
        o = one_serve[dt]
        label = f"layout (c) {arch} {layers} layers {dt}"
        for i, r in enumerate(ranks):
            sv = r["serves"][k]
            di = r["coords"][0]
            want = o["tokens"][di * n:(di + 1) * n]
            same = float((sv["tokens"] == want).mean())
            print(f"# {label} rank {i} {r['coords']}: rows {di * n}-"
                  f"{di * n + n - 1}, parameters {sv['param_bytes']} (one "
                  f"process {o['param_bytes']}), cache {sv['cache']} bytes "
                  f"(one process, all rows, {o['cache']}); prefill "
                  f"{sv['prefill_s']:.3f} s, {LAYOUT_SERVE_STEPS} decode "
                  f"steps {sv['decode_s']:.3f} s over {backend}; peaks "
                  f"prefill {gib(sv['prefill_peak']):.3f} GiB, decode "
                  f"{gib(sv['decode_peak']):.3f} GiB; greedy tokens equal "
                  f"to the one process's: {same:.4f} of {want.size}; gpu "
                  f"{gpu}")
            if dt == "float32":
                check(same == 1.0, f"{label} rank {i}: greedy tokens equal "
                      f"at {same:.4f} of the steps")
                last = o["last"][di * n:(di + 1) * n]
                err = np.abs(sv["last"] - last)
                bound = TP_SERVE_TOL + TP_SERVE_TOL * np.abs(last)
                print(f"# {label} rank {i}: last logits max |diff| "
                      f"{err.max():.3e}, {int((err > bound).sum())} over "
                      f"rtol = atol = {TP_SERVE_TOL:g}")
                check(bool((err <= bound).all()), f"{label} rank {i}: last "
                      f"logits beyond rtol = atol = {TP_SERVE_TOL}")
        if dt != "bfloat16":
            continue
        scfg = dataclasses.replace(configs.get(arch), num_layers=layers,
                                   param_dtype=dt)
        sshape = configs.InputShape(f"{arch}-{layers}", TP_SERVE_PROMPT,
                                    TP_SERVE_ROWS, "prefill")
        total = TP_SERVE_PROMPT + LAYOUT_SERVE_STEPS
        sfc = {"prefill": dryrun.trace_prefill(
                   scfg, sshape, n, ranks=LAYOUT_RANKS, model=LAYOUT_MODEL,
                   kv_layout="hd_model", max_len=total, layout="fsdp"),
               "decode": dryrun.trace_decode(
                   scfg, dataclasses.replace(sshape, seq_len=total,
                                             kind="decode"),
                   n, ranks=LAYOUT_RANKS, model=LAYOUT_MODEL,
                   kv_layout="hd_model", layout="fsdp")}
        for i, r in enumerate(ranks):
            sv = r["serves"][k]
            for kind, f in sfc.items():
                ratio = f["peak_bytes"] / sv[f"{kind}_peak"]
                print(f"# {label} rank {i}: forecast {kind} peak "
                      f"{gib(f['peak_bytes']):.3f} GiB against "
                      f"{gib(sv[f'{kind}_peak']):.3f} measured (ratio "
                      f"{ratio:.3f}); forecast parameters "
                      f"{f['param_bytes_per_rank']}, cache "
                      f"{f['cache_bytes_per_rank']} bytes")
                check(0.85 <= ratio <= 1.15, f"{label} rank {i}: forecast "
                      f"{kind} peak {f['peak_bytes']} against "
                      f"{sv[f'{kind}_peak']}")
            check(sfc["decode"]["param_bytes_per_rank"] == sv["param_bytes"],
                  f"{label} rank {i}: parameter bytes {sv['param_bytes']} "
                  f"against the forecast's "
                  f"{sfc['decode']['param_bytes_per_rank']}")
    print(f"# layout: the phase took {time.perf_counter() - t_phase:.1f} s; "
          f"gpu {gpu}")
    return launches


def timed(label, fn, *args, **kw):
    """fn(*args, **kw), printing its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"# phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import quantize  # noqa: F401
        from repro_torch.launch.serve import build_serve_config
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not importable ({e}); run "
              f"from the repository root", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    gpu = gpu_name_and_power()
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"# gpu: {gpu}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        timed("build", phase_build)
        # the bucket rows and, for four workers with two reporting, the
        # adaptive family's level counts, as the trainer derives them
        t1, s1, layout1, _ = make_trainer(dev, single_strategy(), 1, 0)
        rows = [b.size // 1024 for b in layout1.buckets]
        tw, sw, layoutw, _ = make_trainer(dev, workers_strategy(), WORKERS, 0)
        family = tw._family(sw.params)
        levels_sel = list(family.levels_table()[N_PART - 1])
        print(f"# comm ({WORKERS} workers): {family.describe()}; levels "
              f"with {N_PART} reporting {levels_sel}")
        check(levels_sel != list(family.levels_table()[-1]),
              "the selected family member equals the full plan")
        rows_w = [WORKERS * b.size // 1024 for b in layoutw.buckets]
        del t1, s1, tw, sw
        b1 = timed("kernel B1", phase_kernel, dev, rows, [127] * len(rows),
                   dyn=False)
        b2 = timed("kernel B2", phase_kernel, dev, rows_w, levels_sel,
                   dyn=True)
        # the serving launcher's shapes; contexts 257..319 over its decode
        scfg = build_serve_config(S_PROMPT, S_GEN, S_BATCH)
        ctx = S_PROMPT + S_GEN - 1
        lengths = [S_PROMPT + 1 + (ctx - S_PROMPT - 1) * i // (S_BATCH - 1)
                   for i in range(S_BATCH)]
        b3 = timed("kernel B3", phase_paged_kernel, dev, scfg, lengths)
        b4 = timed("flash", phase_flash_kernel, dev)
        b5 = timed("kernel B5", phase_ssd_kernel, dev)
        lm_b1, lm_b2, lm_call, lm_meas = timed("lm train", phase_lm_train,
                                               dev, gpu)
        zoo_b1, zoo_b2, zoo_call, zoo_meas = timed("zoo", phase_zoo, dev,
                                                   gpu)
        timed("dryrun", phase_dryrun, gpu, lm_meas, zoo_meas)
        tp_b1, backend = timed("tp", phase_tp, dev, gpu, zoo_meas["peaks"])
        layout_b1 = timed("layout", phase_layout, dev, gpu, backend)
        b1["launches"] = timed("train 1 worker", phase_train)
        b2["launches"] = timed("train 4 workers", phase_train_workers, dev)
        b3["launches"] = timed("serve", phase_serve)
        timed("parity 1 worker", phase_parity, dev, 1)
        timed("parity 4 workers", phase_parity, dev, WORKERS)
        timed("parity serve", phase_serve_parity, dev)
        timed("profile 1 worker", phase_profile, dev, 1)
        timed("profile 4 workers", phase_profile, dev, WORKERS)
        timed("profile serve", phase_serve_profile, dev)
        sched = timed("sched", phase_sched, gpu)
        resumed = timed("resume", phase_resume, dev)
        timed("quality", phase_quality, gpu)
        dist_b2 = timed("dist", phase_dist, dev, gpu)
        overlapped = timed("overlap", phase_overlap, dev, gpu)
        observed = timed("obs", phase_obs, dev, gpu)
        fsdp = timed("fsdp", phase_fsdp, dev, gpu)
        quant_b1, quant_b3 = timed("quant", phase_quant, dev, gpu)
        timed("quant parity", phase_quant_parity, dev)
        timed("long", phase_long, dev, gpu)
        timed("swa", phase_swa, dev, gpu)
        # each kernel's launches on the later paths (the main path's
        # count stays "launches")
        b1["launches_by_path"] = {
            **{f"sched {k}": v[0] for k, v in sched.items()},
            **{f"resume {k}": v for k, v in resumed.items()},
            **{f"overlap {k}": v[0] for k, v in overlapped.items()},
            **{k: v[0] for k, v in observed.items() if v[0]},
            **fsdp, **quant_b1, **lm_b1, **zoo_b1, **tp_b1, **layout_b1}
        # B1's one launch over the LM gradient, timed in the profiled
        # window of phase lm train
        b1["lm_call"] = lm_call
        # and over mamba2-1.3b's, timed in phase zoo's profiled window
        b1["zoo_call"] = zoo_call
        b3["launches_by_path"] = quant_b3
        # B5's (forward, backward) calls on each mamba2 path
        b5["launches_by_path"] = dict(SSD_PATHS)
        b2["launches_by_path"] = {
            **{f"sched {k}": v[1] for k, v in sched.items()},
            **{f"dist nccl {k}": v for k, v in dist_b2.items()},
            **{f"overlap {k}": v[1] for k, v in overlapped.items()},
            **{k: v[1] for k, v in observed.items() if v[1]}, **lm_b2,
            **zoo_b2}
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"# gpu: {gpu}")
    print(json.dumps({"kernels": [b1, b2, b3, b4, b5]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
