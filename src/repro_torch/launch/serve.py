"""Serving launcher of the port: a thin CLI over the continuous-batching
engine (paged KV cache, floor-bucket prefill), on one CUDA device (or the
CPU when asked).

    python -m repro_torch.launch.serve --arch gemma-2b --batch 16 \
        --prompt-len 256 --gen 64 --attn-impl kernel
    python -m repro_torch.launch.serve --arch gemma-2b --smoke \
        --device cpu --batch 4 --prompt-len 32 --gen 8

The flags are the JAX launcher's (`repro.launch.serve`), plus ``--device``
(default ``cuda``; the launcher exits with an error when no CUDA device
is present, and never falls back to the CPU on its own) and
``--attn-impl``: ``gather`` (the default, as the JAX engine's) or
``kernel``, B3 as a CUDA kernel, the counterpart of the JAX engine's
``pallas``. Weights are random from ``--seed``, in the config's
``param_dtype`` (bfloat16 for gemma-2b at full width, float32 under
``--smoke``). On CUDA, TF32 is off for float32 matmuls.

It prints one JSON row: the JAX launcher's ``arch``, ``mode``, ``batch``,
``prompt_len``, ``generated``, ``tokens_per_s`` (wall clock of the run,
prefills included), ``weights`` and ``sample_tokens``, plus ``attn_impl``
and ``decode_step_s``, the median wall time of one engine step (which
ends with its tokens on the host, a device sync; null with
``--sequential``), and ``load_s``, the wall time of building the runner
(the weight quantization included; outside ``tokens_per_s``). The JAX
launcher's ``--assert-single-trace`` has no counterpart: the port runs
eagerly and traces nothing.

``--quantize-weights COMPRESSOR`` (a linf quantizer, e.g. qsgd8_linf)
serves quantized weights, B1 once a bucket at load: ``--weight-plan``
picks the per-bucket bits (none|uniform|size_tiered|delta_budget) and
``--weight-budget-mb`` the delta_budget payload; ``weights`` then
describes the payload. Without ``--quantize-weights`` both are ignored,
as in the JAX launcher. The engine serves global attention and the
recurrent mixers (mamba2-1.3b: a state lane a slot). Sliding-window
models (gemma-2b-swa, recurrentgemma-2b) and encoder-decoder models
(whisper-tiny) are refused: the paged cache does not take them, as in the
JAX package; they run through `model.prefill` / `model.decode_step`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch import configs
from repro_torch.models import model as lm
from repro_torch.serve import (
    Engine,
    Request,
    SequentialGenerator,
    ServeConfig,
    ServeError,
    cdiv,
    check_model_servable,
)
from repro_torch.strategy import Compression, StrategyError


def build_serve_config(prompt_len: int, gen: int, batch: int) -> ServeConfig:
    """Shapes sized to the workload: enough blocks for `batch` concurrent
    requests of this prompt/gen length, buckets no larger than the prompt
    (floor-bucket prefill). The JAX launcher's sizing."""
    bs = 16
    need = max(prompt_len + gen - 1, 1)
    mbps = max(cdiv(need, bs), 1)
    buckets = tuple(b for b in (16, 32, 64, 128, 256, 512)
                    if b <= max(prompt_len, 16))
    return ServeConfig(
        max_batch=batch,
        block_size=bs,
        num_blocks=batch * mbps + 2,
        max_blocks_per_seq=mbps,
        prompt_buckets=buckets,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests (and engine decode slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="batch-1 baseline instead of the batching engine")
    ap.add_argument("--attn-impl", choices=("gather", "kernel"),
                    default="gather",
                    help="paged decode attention: gather (default) or "
                         "kernel (B3, the CUDA kernel)")
    ap.add_argument("--quantize-weights", default=None, metavar="COMPRESSOR",
                    help="serve quantized weights, e.g. qsgd8_linf")
    ap.add_argument("--weight-plan", default="none",
                    help="per-bucket bit plan: none|uniform|size_tiered|"
                         "delta_budget")
    ap.add_argument("--weight-budget-mb", type=float, default=0.0)
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
        ap.error(str(e.args[0]))
    if args.smoke:
        cfg = cfg.reduced()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    compression = None
    try:
        check_model_servable(cfg)
        scfg = build_serve_config(args.prompt_len, args.gen, args.batch)
        if args.quantize_weights:
            compression = Compression(compressor=args.quantize_weights,
                                      plan=args.weight_plan,
                                      budget_mb=args.weight_budget_mb)
    except (ServeError, StrategyError) as e:
        ap.error(str(e))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init(cfg, generator=gen, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device).tolist()
    requests = [Request(rid=i, prompt=prompts[i], max_new=args.gen,
                        temperature=args.temperature)
                for i in range(args.batch)]

    _sync(device)
    t_load = time.perf_counter()
    try:
        runner = (SequentialGenerator if args.sequential else Engine)(
            cfg, scfg, params, compression=compression, seed=args.seed,
            **({} if args.sequential else {"attn_impl": args.attn_impl}))
    except ServeError as e:       # a compressor that is not linf
        ap.error(str(e))
    del params        # a quantized runner keeps only its payload
    _sync(device)
    load_s = time.perf_counter() - t_load

    step_s = []
    t0 = time.perf_counter()
    if args.sequential:
        outputs = {r.rid: runner.generate(list(r.prompt), r.max_new,
                                          rid=r.rid,
                                          temperature=r.temperature)
                   for r in requests}
    else:
        for r in requests:
            runner.submit(r)
        while not runner.idle:
            ts = time.perf_counter()
            if not runner.step() and runner.queue:
                raise ServeError("admission deadlock: queue non-empty but "
                                 "nothing admitted with all slots free")
            step_s.append(time.perf_counter() - ts)
        outputs = runner.outputs
    _sync(device)
    dt = time.perf_counter() - t0

    total = sum(len(v) for v in outputs.values())
    row = {
        "arch": cfg.name,
        "mode": "sequential" if args.sequential else "engine",
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "generated": total,
        "tokens_per_s": round(total / max(dt, 1e-9), 1),
        "weights": runner.stats()["weights"],
        "sample_tokens": outputs[0][:8],
        "attn_impl": "dense" if args.sequential else args.attn_impl,
        "decode_step_s": (round(statistics.median(step_s), 6)
                          if step_s else None),
        "load_s": round(load_s, 6),
    }
    print(json.dumps(row), flush=True)
    return {"row": row, "outputs": outputs, "stats": runner.stats()}


if __name__ == "__main__":
    main()
