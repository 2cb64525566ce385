"""What bounds B3 and B4 on the card, reported and not checked:

    PYTHONPATH=src python -m repro_torch.kernels.probe

- the floor of a call: a one-element add, B3 at one row of L = 1 and B4 at
  (1, 1, 16), with the L2 cache cold and warm;
- each kernel at cluster sizes 1, 2, 4 and 8 in place of its plan's
  choice: B3 at gemma-2b's serving shape (16 rows, K = 1, G = 8, D = 256,
  bs = 16, MAXB = 20, contexts 257..319) in both types, B4 causal at the
  JAX kernel benchmark's full tier (4, 1024, 128) in float32 and at one
  gemma-2b prefill call (8, 256, 256) in bfloat16;
- B4 in bfloat16, causal, against SDPA at long sequences, in TFLOP/s.

Each time is the mean of CUDA-event times over 100 calls (50 at long
sequences), with the L2 cache overwritten before each call unless it is
warm, as `chip_smoke.py` times its kernels.
"""
from __future__ import annotations

import subprocess
import sys
from unittest import mock

import torch
import torch.nn.functional as F

from . import flash_attention as FA

CLUSTERS = (1, 2, 4, 8)


def _ms(fn, iters, flush):
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # the host queues fn ahead of the card
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _paged(dev, seed, B, G, D, bs, maxb, lengths, dtype):
    """q and pools at K = 1 from `seed`, each row over distinct pool
    blocks in random order."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    NB = 1 + B * maxb
    table = (torch.randperm(NB - 1, generator=torch.Generator()
                            .manual_seed(seed)) + 1).view(B, maxb)
    q, pk, pv = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, 1, G, D), (NB, bs, 1, D), (NB, bs, 1, D)))
    return (q, pk, pv, table.to(dev, torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _flash(dev, seed, BH, S, D, dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((BH, S, D), generator=gen, device=dev)
                 .to(dtype) for _ in range(3))


def _drop_plans():
    FA._paged_plans.clear()
    FA._flash_plans.clear()


def _sweep(plan, fn, flush):
    """fn's times with `plan` (FA.paged_split or FA.flash_split) giving
    each of CLUSTERS, the wrappers' kept plans dropped around each."""
    times = []
    for c in CLUSTERS:
        _drop_plans()
        with mock.patch.object(FA, plan, lambda *args, c=c: c):
            times.append(_ms(fn, 100, flush))
    _drop_plans()
    return " / ".join(f"{t:.4f}" for t in times)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"# gpu: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    bf16, f32 = torch.bfloat16, torch.float32
    cold = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    warm = torch.empty(16, dtype=torch.uint8, device=dev)

    one = torch.zeros(1, device=dev)
    tiny_b3 = _paged(dev, 1, 1, 1, 16, 16, 1, [1], bf16)
    tiny_b4 = _flash(dev, 1, 1, 1, 16, bf16)
    for name, flush in (("cold", cold), ("warm", warm)):
        add = _ms(lambda: one.add_(1), 100, flush)
        b3 = _ms(lambda: FA.paged_flash_attention(*tiny_b3), 100, flush)
        b4 = _ms(lambda: FA.flash_attention(*tiny_b4, bq=1, bk=1), 100,
                 flush)
        print(f"# probe floor ({name} L2): a one-element add {add:.4f} ms, "
              f"B3 at one row of L = 1 {b3:.4f} ms, B4 at (1, 1, 16) "
              f"{b4:.4f} ms")

    lengths = [257 + 62 * i // 15 for i in range(16)]
    for dtype in (bf16, f32):
        ops = _paged(dev, 10, 16, 8, 256, 16, 20, lengths, dtype)
        times = _sweep("paged_split",
                       lambda: FA.paged_flash_attention(*ops), cold)
        print(f"# probe B3 {str(dtype)[6:]} at the serving shape, cluster "
              f"1 / 2 / 4 / 8: {times} ms (the plan: "
              f"{FA.paged_split(16, 1, 20, FA.sm_count(dev))})")
    for label, BH, S, D, dtype in (("(a)", 4, 1024, 128, f32),
                                   ("(d)", 8, 256, 256, bf16)):
        q, k, v = _flash(dev, 20, BH, S, D, dtype)
        times = _sweep("flash_split", lambda: FA.flash_attention(q, k, v),
                       cold)
        bq, bk = FA.flash_tiles(dtype, D)
        print(f"# probe B4 {label} ({BH}, {S}, {D}) {str(dtype)[6:]}, "
              f"cluster 1 / 2 / 4 / 8: {times} ms (the plan: "
              f"{FA.flash_split(BH, S, bq, bk, FA.sm_count(dev))})")

    for BH, S, D in ((16, 2048, 128), (8, 1024, 256)):
        q, k, v = _flash(dev, 30, BH, S, D, bf16)
        gflop = 4 * D * S * (S + 1) // 2 * BH / 1e9
        ms = _ms(lambda: FA.flash_attention(q, k, v), 50, cold)
        sdpa = _ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), 50, cold)
        print(f"# probe B4 bf16 causal ({BH}, {S}, {D}): kernel {ms:.4f} ms "
              f"({gflop / ms:.1f} TFLOP/s), SDPA {sdpa:.4f} ms "
              f"({gflop / sdpa:.1f} TFLOP/s)")
    print(f"# gpu: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
