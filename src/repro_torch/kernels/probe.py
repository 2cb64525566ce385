"""What bounds B1, B3 and B4 on the card, and what the bf16 GELU costs the
decode step, reported and not checked:

    PYTHONPATH=src python -m repro_torch.kernels.probe

- the floor of a call: a one-element add, B3 at one row of L = 1 and B4 at
  (1, 1, 16), with the L2 cache cold and warm;
- B1 over one dcgan32 training step's rows (its comm buckets of 648, 648
  and 512 rows of 1024, packed back to back) at 127 levels, in one launch
  and in one launch a bucket, for the source as it stands and for edited
  copies of it, each held bit-equal to the plain version: the one-block-a-
  row body at these rows (`rows`), the one-warp-a-row body with 2, 4 or
  16 rows a block, with plain loads and stores in place of the
  evict-first ones, and with the rand loads after the row max;
- gemma-2b at full width in bfloat16, 16 rows decoding: the engine's
  decode step with the tanh GELU evaluated op by op (the port's, as
  `jax.nn.gelu` does) and with `F.gelu(approximate="tanh")` in its place,
  in alternating blocks of steps (ABBA), wall time per step;
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

import ctypes
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

from . import _build
from . import flash_attention as FA
from .ref import quantize_ef_ref

CLUSTERS = (1, 2, 4, 8)
B1_BUCKET_ROWS = (648, 648, 512)   # dcgan32's comm buckets, rows of 1024
# edited copies of csrc/quantize_ef.cu: (name, [(text, replacement), ...])
B1_ST_PLAIN = ("template <typename T>\n__device__ __forceinline__ void "
               "st_plain(T* p, T v) { *p = v; }\nconstexpr int kRowCols")
B1_RAND_LOADS = ("#pragma unroll\n  for (int j = 0; j < kRowVecs; ++j) "
                 "r[j] = __ldcs(r4 + 32 * j);\n")
B1_STEP = "  const float step = __fdiv_rn(s, levels);\n"
B1_VARIANTS = (
    ("repo", []),
    ("rows", [("if (!kDyn && cols == kRowCols) {", "if (false) {")]),
    ("rows_per_block 2", [("kRowsPerBlock = 8;", "kRowsPerBlock = 2;")]),
    ("rows_per_block 4", [("kRowsPerBlock = 8;", "kRowsPerBlock = 4;")]),
    ("rows_per_block 16", [("kRowsPerBlock = 8;", "kRowsPerBlock = 16;")]),
    ("plain loads and stores", [("__ldcs(", "__ldg("),
                                ("__stcs(", "st_plain("),
                                ("constexpr int kRowCols", B1_ST_PLAIN)]),
    ("rand after the row max", [(B1_RAND_LOADS, ""),
                                (B1_STEP, B1_STEP + B1_RAND_LOADS)]),
)


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


def _b1_libraries():
    """Build every B1_VARIANTS copy of the B1/B2 source at once (one nvcc
    each); returns {name: its quantize_ef_f32}."""
    src = _build.SOURCES["quantize_ef"].read_text()
    out = _build.build_dir() / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in B1_VARIANTS:
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"probe B1 {name}: {a!r} not in the source")
            text = text.replace(a, b)
        stem = name.replace(" ", "_")
        cu = out / f"quantize_ef_{stem}.cu"
        cu.write_text(text)
        lib = out / f"libquantize_ef_{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe B1 {name}: nvcc failed:\n{log}")
        fn = ctypes.CDLL(str(lib)).quantize_ef_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_float,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _b1(dev, flush):
    """B1_VARIANTS at one training step's rows: bit-equal to the plain
    version, then timed in one launch and in one launch a bucket."""
    gen = torch.Generator(device=dev).manual_seed(0)
    R = sum(B1_BUCKET_ROWS)
    g = 0.3 * torch.randn((R, 1024), generator=gen, device=dev)
    e = 0.05 * torch.randn((R, 1024), generator=gen, device=dev)
    r = torch.rand((R, 1024), generator=gen, device=dev)
    codes = torch.empty((R, 1024), dtype=torch.int8, device=dev)
    scale = torch.empty((R, 1), device=dev)
    e_new = torch.empty_like(e)
    want = quantize_ef_ref(g, e, r, 127)
    stream = torch.cuda.current_stream(dev).cuda_stream
    starts = [sum(B1_BUCKET_ROWS[:i]) for i in range(len(B1_BUCKET_ROWS))]

    def call(fn, r0, rows):
        rc = fn(g[r0].data_ptr(), e[r0].data_ptr(), r[r0].data_ptr(),
                codes[r0].data_ptr(), scale[r0].data_ptr(),
                e_new[r0].data_ptr(), rows, 1024, 127.0, stream)
        if rc:
            raise RuntimeError(f"probe B1: CUDA error {rc}")

    for name, fn in _b1_libraries().items():
        call(fn, 0, R)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b)
                   for a, b in zip((codes, scale, e_new), want))
        one = _ms(lambda: call(fn, 0, R), 100, flush)
        per = _ms(lambda: [call(fn, r0, n) for r0, n in
                           zip(starts, B1_BUCKET_ROWS)], 100, flush)
        print(f"# probe B1 [{name}] rows {list(B1_BUCKET_ROWS)} x 1024, "
              f"127 levels: bit-equal {same}; one launch {one:.4f} ms, "
              f"one a bucket {per:.4f} ms")


def _c1(dev, blocks=12, steps=5):
    """The decode step's wall time with the op-by-op GELU (A) and with
    F.gelu (B), in ABBA blocks of `steps` steps on one engine."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import build_serve_config
    from repro_torch.models import layers
    from repro_torch.models import model as lm
    from repro_torch.serve import Engine, Request

    cfg = get("gemma-2b")
    gen = torch.Generator(device=dev).manual_seed(3)
    params = lm.init(cfg, generator=gen, device=dev)
    new = 6 + blocks * steps
    eng = Engine(cfg, build_serve_config(256, new, 16), params,
                 attn_impl="kernel")
    prompts = torch.randint(0, cfg.vocab_size, (16, 256), generator=gen,
                            device=dev).tolist()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=new))
    ours = layers._gelu_tanh
    variants = {"op by op": ours,
                "F.gelu": lambda v: F.gelu(v, approximate="tanh")}
    times = {k: [] for k in variants}
    try:
        for name in variants:   # admission and warm-up, two steps each
            layers._gelu_tanh = variants[name]
            eng.step()
            eng.step()
        for i in range(blocks):
            name = ("op by op", "F.gelu")[(i + 1) // 2 % 2]   # A B B A ...
            layers._gelu_tanh = variants[name]
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        layers._gelu_tanh = ours
    a, b = (statistics.median(times[k]) for k in variants)
    print(f"# probe C1 gemma-2b bf16 decode step, 16 rows, kernel path, "
          f"{blocks} ABBA blocks of {steps} steps: median {a:.3f} ms with "
          f"the op-by-op GELU, {b:.3f} ms with F.gelu, difference "
          f"{a - b:+.3f} ms (min {min(times['op by op']):.3f} / "
          f"{min(times['F.gelu']):.3f} ms)")
    del eng, params
    torch.cuda.empty_cache()


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

    _b1(dev, cold)
    _c1(dev)

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
