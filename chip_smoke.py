#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

  1. build   every CUDA kernel of the port from its source (nvcc, parallel)
  2. kernel  hold each kernel against its plain PyTorch version on the card,
             at the trainer's shapes and at edge cases, and time both
  3. train   drive the trainer's main path through its CLI entry point:
             single-worker DQGAN on dcgan32 at full width, batch 64,
             omd/update, qsgd8_block1024 over uniform buckets; the launch
             count of every kernel is zeroed just before and read just after
  4. parity  one trainer step with the kernel and the same step with the
             plain quantizer, same draws, compared

The line before the last is {"kernels": [...]}, one record per kernel with
its launches on the main path, its error against the plain version, its
time, the plain version's, and the least time the card could take (bytes
over 3.35 TB/s or flops over 67 TFLOP/s f32, the H100 SXM data sheet's
peaks). The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12     # H100 SXM, float32 outside the tensor cores
STEPS, BATCH = 20, 64


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


# --------------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"# build: {len(logs)} kernel source(s) in {dt:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {name}: {line.strip()}")


def compare_quantize(g, e, r, levels):
    """Kernel vs plain on the same CUDA tensors. Returns (max |Δe'|, code
    mismatch fraction, list of failed checks)."""
    import torch
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.ref import quantize_ef_ref
    R = g.shape[0]
    ck, sk, ek = Q.quantize_ef_blocked(g, e, r, levels=levels, block_rows=R)
    cp, sp, ep = quantize_ef_ref(g, e, r, levels)
    torch.cuda.synchronize()
    step = sk / sk.new_tensor(float(levels))
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


def phase_kernel(dev, bucket_rows):
    import torch
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.ref import quantize_ef_ref
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(R, C):
        g = 0.3 * torch.randn((R, C), generator=gen, device=dev)
        e = 0.05 * torch.randn((R, C), generator=gen, device=dev)
        r = torch.rand((R, C), generator=gen, device=dev)
        return g, e, r

    # (label, R, C, levels, edit): the trainer's bucket rows, then edges
    cases = [("bucket", R, 1024, 127, None) for R in
             sorted(set(bucket_rows))]
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
    # a code flip needs rand within float rounding of the fractional part:
    # expected ~1e-7 of elements, allow 1e-5
    max_mismatch = 1e-5
    worst, bad = 0.0, []
    for label, R, C, L, edit in cases:
        g, e, r = operands(R, C)
        if edit == "zero":
            g[3].zero_()
            e[3].zero_()
        elif edit == "huge":
            g[5, 17] = 3.0e20
        err, mism, failed = compare_quantize(g, e, r, L)
        if mism > max_mismatch:
            failed.append(f"code mismatch {mism:.2e} > {max_mismatch:.0e}")
        if label == "bucket":
            worst = max(worst, err)
        print(f"# kernel quantize_ef [{label}] R={R} C={C} L={L}: "
              f"max|de'|={err:.3e} "
              f"code mismatch={mism:.2e}"
              + (f" FAILED: {'; '.join(failed)}" if failed else ""))
        bad += [f"{label}: {f}" for f in failed]
    check(not bad, "quantize_ef disagrees with its plain version: "
          + "; ".join(bad))

    # time one step's work: one launch per bucket at the trainer's shapes
    ops = [operands(R, 1024) for R in bucket_rows]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def run_kernel():
        for g, e, r in ops:
            Q.quantize_ef_blocked(g, e, r, block_rows=g.shape[0])

    def run_plain():
        for g, e, r in ops:
            quantize_ef_ref(g, e, r)

    ms = time_ms(run_kernel, 50, flush)
    plain_ms = time_ms(run_plain, 50, flush)
    n = sum(R * 1024 for R in bucket_rows)
    rows = sum(bucket_rows)
    nbytes = n * (4 + 4 + 4 + 1 + 4) + rows * 4  # g, e, rand; codes, e'; s
    flops = 11 * n  # add, abs, max, div, mul, floor, sub, cmp, add, mul, sub
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    print(f"# kernel quantize_ef timing, {len(bucket_rows)} launches "
          f"({n} elements, {nbytes / 1e6:.2f} MB): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms")
    return {"name": "quantize_ef", "route": "cuda",
            "source": "src/repro_torch/csrc/quantize_ef.cu",
            "replaces": "src/repro/kernels/quantize.py:42",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_train():
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    argv = ["--arch", "dcgan32", "--steps", str(STEPS), "--batch", str(BATCH),
            "--optimizer", "omd", "--lr", "1e-4",
            "--compressor", "qsgd8_block1024", "--comm-plan", "uniform",
            "--log-every", "1", "--device", "cuda"]
    Q.reset_launches()
    history = train.main(argv)
    launches = Q.launches
    check(len(history) == STEPS, f"{len(history)} log rows for {STEPS} steps")
    for rec in history:
        for k in ("loss", "grad_norm", "error_norm"):
            check(math.isfinite(rec[k]), f"step {rec['step']}: {k} = {rec[k]}")
    check(launches == STEPS * 3,
          f"quantize_ef launched {launches} times in {STEPS} steps, "
          f"expected {STEPS * 3} (3 buckets per step)")
    step_ms = statistics.median(r["step_s"] for r in history[1:]) * 1e3
    print(f"# train dcgan32 full width, batch {BATCH}: {STEPS} steps, "
          f"quantize_ef launches {launches}, median step {step_ms:.3f} ms "
          f"(first step {history[0]['step_s'] * 1e3:.1f} ms)")
    return launches, step_ms


def phase_parity(dev):
    """The same trainer step with the kernel and with the plain quantizer."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan, error_feedback
    from repro_torch.data import procedural_images
    from repro_torch.kernels.ref import quantize_ef_ref
    from repro_torch.models import gan
    from repro_torch.strategy import Compression, Strategy

    torch.backends.cudnn.deterministic = True  # same field in both runs
    torch.backends.cudnn.benchmark = False
    cfg = get("dcgan32")
    strat = Strategy(compression=Compression(compressor="qsgd8_block1024",
                                             plan="uniform"))
    dq = DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4,
                                message="update")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = gan.init(cfg, generator=gen, device=dev)
    trainer = dqgan.DQGAN(field_fn=gan.gan_field_fn(cfg), dq=dq, device=dev)
    state = trainer.init(params)
    layout, _ = trainer._comm(params)
    results = []
    for _ in range(2):  # a second step so that e_prev is not zero
        batch = {"real": procedural_images(BATCH, 32, 3, generator=gen,
                                           device=dev)}
        draws = {"z": torch.randn((BATCH, cfg.latent_dim), generator=gen,
                                  device=dev),
                 "rand": {b.bid: torch.rand((b.size,), generator=gen,
                                            device=dev)
                          for b in layout.buckets}}
        kern = trainer.step(state, batch, draws)

        def plain_flat(g, e, rand, *, levels=127):
            n = g.shape[0]
            c, s, en = quantize_ef_ref(g.reshape(-1, 1024),
                                       e.reshape(-1, 1024),
                                       rand.reshape(-1, 1024), levels)
            return c.reshape(n), s.reshape(-1), en.reshape(n)

        with mock.patch.object(error_feedback, "quantize_ef_flat",
                               plain_flat):
            plain = trainer.step(state, batch, draws)
        w0 = T.leaves(state.params)
        pk, pp = T.leaves(kern.state.params), T.leaves(plain.state.params)
        ek = [x[0] for x in T.leaves(kern.state.ef["leaf"])]
        ep = [x[0] for x in T.leaves(plain.state.ef["leaf"])]
        # the quantized message m = p̂ + e' = (w − w') + e', and one
        # quantization step of the largest row scale: max|m|/127
        qstep = max(((w - a) + x).abs().max().item()
                    for w, a, x in zip(w0, pk, ek)) / 127
        d_par = max((a - b).abs().max().item() for a, b in zip(pk, pp))
        n_diff = sum(int((a != b).sum()) for a, b in zip(pk, pp))
        n_all = sum(a.numel() for a in pk)
        # p̂ + e' = m: params − e1 cancels a code flipped at a boundary
        d_inv = max(((a - x) - (b - y)).abs().max().item()
                    for a, b, x, y in zip(pk, pp, ek, ep))
        results.append((d_par, d_inv, qstep, n_diff / n_all))
        state = kern.state
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    for i, (d_par, d_inv, qstep, frac) in enumerate(results):
        # params within one quantization step (a code flipped at a rounding
        # boundary) on at most 1e-5 of the elements; params − e1 to float32
        # rounding of the parameters (|w| < 1)
        check(d_par <= qstep * 1.001, f"step {i}: params differ by "
              f"{d_par:.3e} > one quantization step {qstep:.3e}")
        check(frac <= 1e-5, f"step {i}: {frac:.2e} of the params differ")
        check(d_inv <= 1e-6, f"step {i}: params - e1 differ by {d_inv:.3e}")
        print(f"# parity kernel vs plain, trainer step {i}: max|dparams|="
              f"{d_par:.3e} (quantization step {qstep:.3e}), params "
              f"differing {frac:.2e}, max|d(params - e1)|={d_inv:.3e}")


def phase_profile(dev, steps=10):
    """Where the trainer's step time goes: torch.profiler over a window of
    steps, device time by kernel and the device's busy share. Reported,
    not checked (the profiler's device tracing is not relied on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import DQConfig, get
    from repro_torch.core import dqgan
    from repro_torch.data import procedural_images
    from repro_torch.models import gan
    from repro_torch.strategy import Compression, Strategy

    cfg = get("dcgan32")
    strat = Strategy(compression=Compression(compressor="qsgd8_block1024",
                                             plan="uniform"))
    dq = DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4,
                                message="update")
    gen = torch.Generator(device=dev).manual_seed(2)
    trainer = dqgan.DQGAN(field_fn=gan.gan_field_fn(cfg), dq=dq, device=dev)
    state = trainer.init(gan.init(cfg, generator=gen, device=dev))
    batches = [{"real": procedural_images(BATCH, 32, 3, generator=gen,
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
    kern = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0) or 0
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kern[ev.key] = (kern.get(ev.key, (0, 0))[0] + dt / 1e3,
                            kern.get(ev.key, (0, 0))[1] + ev.count)
    busy_ms = sum(t for t, _ in kern.values())
    if not kern:
        print("# profile: the profiler recorded no device time (not "
              "measured)")
        return
    print(f"# profile {steps} steps: wall {wall_ms / steps:.3f} ms/step "
          f"(profiler on), device busy {busy_ms / steps:.3f} ms/step, "
          f"busy share {busy_ms / wall_ms:.3f}, "
          f"{sum(c for _, c in kern.values()) / steps:.0f} kernels/step")
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t, c) in top:
        print(f"#   {t / steps:8.4f} ms/step {c / steps:5.1f}x  {name[:90]}")
    q = sum(t for n, (t, _) in kern.items() if "quantize_ef" in n)
    print(f"#   quantize_ef kernels: {q / steps:.4f} ms/step "
          f"({q / busy_ms:.3f} of device busy time)")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import quantize  # noqa: F401
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
        from repro_torch.configs import get
        from repro_torch.comm import build_layout
        from repro_torch import tree as T
        from repro_torch.models import gan
        shapes = T.tree_map(lambda x: tuple(x.shape),
                            gan.init(get("dcgan32"), device="meta"))
        rows = [b.size // 1024 for b in build_layout(shapes).buckets]
        record = phase_kernel(dev, rows)
        launches, step_ms = phase_train()
        record["launches"] = launches
        phase_parity(dev)
        phase_profile(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"# gpu: {gpu}")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
