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
          "flash_attention (d) gemma-2b prefill": 0.0601}


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


def make_trainer(dev, strat, workers, seed):
    """(trainer, initial state, bucket layout) of dcgan32 at full width."""
    import torch
    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan
    from repro_torch.models import gan
    cfg = get("dcgan32")
    dq = DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4,
                                message="update")
    gen = torch.Generator(device=dev).manual_seed(seed)
    trainer = dqgan.DQGAN(field_fn=gan.gan_field_fn(cfg), dq=dq, device=dev,
                          workers=workers)
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
        return
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


def phase_serve():
    """Serve gemma-2b at full width through the launcher, with B3 (kernel)
    and with the gather path; returns B3's launches on the kernel run."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import serve
    from repro_torch.configs import get
    layers = get("gemma-2b").num_layers
    runs = {}
    for impl in ("kernel", "gather"):
        FA.reset_launches()
        Q.reset_launches()
        res = serve.main(S_ARGS + ["--attn-impl", impl])
        b3, b1, b2, b4 = (FA.launches, Q.launches, Q.launches_dyn,
                          FA.flash_launches)
        row, steps = res["row"], res["stats"]["steps"]
        # prompt 256 is a bucket: the prefill yields token 0, then one
        # decode step per further token, all 16 requests in one batch
        check(row["generated"] == S_BATCH * S_GEN,
              f"serve {impl}: generated {row['generated']} tokens, expected "
              f"{S_BATCH * S_GEN}")
        check(steps == S_GEN - 1, f"serve {impl}: {steps} engine steps, "
              f"expected {S_GEN - 1}")
        check(b3 == (steps * layers if impl == "kernel" else 0),
              f"serve {impl}: paged_attention launched {b3} times in {steps} "
              f"steps of {layers} layers")
        check(b1 == b2 == b4 == 0, f"serve {impl}: quantize_ef launched "
              f"{b1}, quantize_ef_dyn {b2}, flash_attention {b4} times, "
              f"expected 0")
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
        phase_build()
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
        b1 = phase_kernel(dev, rows, [127] * len(rows), dyn=False)
        b2 = phase_kernel(dev, rows_w, levels_sel, dyn=True)
        # the serving launcher's shapes; contexts 257..319 over its decode
        scfg = build_serve_config(S_PROMPT, S_GEN, S_BATCH)
        ctx = S_PROMPT + S_GEN - 1
        lengths = [S_PROMPT + 1 + (ctx - S_PROMPT - 1) * i // (S_BATCH - 1)
                   for i in range(S_BATCH)]
        b3 = phase_paged_kernel(dev, scfg, lengths)
        b4 = phase_flash_kernel(dev)
        b1["launches"] = phase_train()
        b2["launches"] = phase_train_workers(dev)
        b3["launches"] = phase_serve()
        phase_parity(dev, 1)
        phase_parity(dev, WORKERS)
        phase_serve_parity(dev)
        phase_profile(dev, 1)
        phase_profile(dev, WORKERS)
        phase_serve_profile(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"# gpu: {gpu}")
    print(json.dumps({"kernels": [b1, b2, b3, b4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
