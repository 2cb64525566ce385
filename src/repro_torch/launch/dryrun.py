"""Dry-run of every (architecture x input shape) on the production fleet
(counterpart of `repro.launch.dryrun`), on the meta device: no card, no
allocation on any device.

The JAX package lowers and compiles each combo on its production meshes
and reads XLA's cost and memory analyses. The port runs eagerly, so it
traces instead: one rank's step (or prefill, or decode step) runs on meta
tensors at the published widths under `launch.op_analysis`, which counts
every op's FLOPs and result bytes and the peak of live bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

How a combo runs. A production fleet of 256 (one pod, `--mesh single`)
or 512 (`multi`) cards is that many ranks, one card each.
- train: the port's `DQGAN` over meta params, one rank of a `meta_mesh`
  of that many ranks (`core.exchange.MetaWorkers`,
  `parallel.tensor.MetaModelGroup` and `parallel.fsdp.MetaFsdpGroup`:
  the rank's own ops and each collective's result buffer, no
  communication), laid out as the reference lays the combo out. Under
  layout `dp` the ranks form the JAX package's (data, model) grid, (16,
  16) or (2·16, 16): each rank holds its shards of the parameters under
  the rules (`parallel.sharding`), the workers run over 'pod' × 'data'
  (16, or 32 sharing the global batch of 256 in the multi-pod fleet),
  the flags' per-leaf exchange; every arch, the mixers and the
  encoder-decoder too. Under `fsdp` (the reference's Mode B, `auto`
  above 10 B parameters) the ranks form (16, 16) or (2, 16, 16) ('pod',
  'data', 'model'): a rank holds its shard of each parameter cut over
  'data' and 'model', the field gathers each period's parameters over
  the data ranks (`parallel.fsdp`), and the workers are the pods: one
  on a pod (the reference's single-worker step), two across pods under
  the reference's vmap step with exchange `sim`. One `step` on one
  rank's rows of the global batch.
- prefill: the sharded bundle's `prefill` (`models.build(cfg, mesh)`) of
  the rank's rows (the shape's batch split per `batch_spec`) on its
  parameter shards under the record's layout, one rank of the
  production mesh, its 'model' axis 16, filling the rank's part of the
  cache in the record's `kv_layout`.
- decode: the sharded bundle's `decode_step` of the rank's rows against
  the rank's part of dense caches of `seq_len` (`init_cache` under
  `cache_specs` at `kv_layout`), on the same shards.
In every record a rank's parameter bytes (`param_bytes_per_rank`) are
the reference's per-device bytes under the same layout
(`param_bytes_per_device`).
A `*_block1024` compressor's kernel is traced as the card runs it: one
op with its outputs (`kernels.meta`); B5, mamba2's chunked SSD, as the
allocations its wrapper makes on the card, with no launch (`kernels.ssd`).

The record keeps the JAX package's keys where they mean the same (arch,
shape, mesh, status, params, active_params, mf, analytic_flops,
bottleneck, flops, traffic_result_bytes, collectives) and adds:
`peak_bytes` (the rank's own step: what the card must hold), `fits`
(`peak_bytes` within HBM_BYTES), `param_bytes_per_device` (under the JAX
package's layout, its 'model' axis included, labelled as such),
`param_bytes_per_rank` (what the traced rank holds: equal to the
former), `model_axis`, `collectives_model` and `collectives_fsdp` (the
model group's and the fsdp group's, apart from the exchange's
`collectives`); for prefill and decode `cache_bytes_per_rank` (the
traced rank's cache) and `cache_bytes_per_device` (the JAX package's
layout of the same cache under `cache_specs`, equal to the former);
`ledger` (the
`comm.CommLedger` per-step wire bytes of the strategy at that worker
count) and `roofline` {compute_s, memory_s, collective_s} at the H100
SXM data-sheet constants below. The JAX package's TPU constants are not
used.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch import configs as cfgs

# H100 SXM data-sheet constants (per card), not measurements
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12         # bytes/s, HBM3
NIC_BW = 50e9            # bytes/s per card, one 400 Gb/s NDR InfiniBand port
HBM_BYTES = 80e9         # the card's memory
CONSTANTS = {"peak_flop_s": PEAK_FLOPS, "hbm_bytes_s": HBM_BW,
             "nic_bytes_s": NIC_BW, "hbm_bytes": HBM_BYTES,
             "source": "NVIDIA H100 SXM data sheet"}
SHAPE_NAMES = tuple(cfgs.SHAPES)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only; N active for
    MoE. D = tokens processed per step (whole job, all cards)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def attention_flops(cfg, shape) -> float:
    """Analytic attention FLOPs (not covered by 6·N·D): 4·tokens·Keff·H·hd
    per attention layer forward (QKᵀ + PV), ×3 with backward for training.
    Keff = average attended keys (causal ≈ S/2, bounded by the window)."""
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_pattern[i % len(cfg.layer_pattern)] == "attn")
    if cfg.is_encdec:
        n_attn += cfg.encdec.enc_layers + cfg.num_layers  # enc self + cross
    if n_attn == 0:
        return 0.0
    S = shape.seq_len
    H, hd = cfg.num_heads, cfg.head_dim
    win = cfg.attention_window
    if shape.kind == "decode":
        keff = min(S, win) if win else S
        tokens = shape.global_batch
        mult = 1.0
    else:
        keff = min(S / 2, win) if win else S / 2
        tokens = shape.global_batch * S
        mult = 3.0 if shape.kind == "train" else 1.0
    return mult * 4.0 * tokens * keff * H * hd * n_attn


def analytic_flops(cfg, shape) -> float:
    return model_flops(cfg, shape) + attention_flops(cfg, shape)


def applicable(cfg, shape) -> tuple:
    """(runs?, reason)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic attention (DESIGN.md §long_500k)")
    return True, ""


# --------------------------------------------------------------------------- #
# the traced part
# --------------------------------------------------------------------------- #
def train_strategy(layout: str, *, exchange: str = "two_phase",
                   compressor: str = "qsgd8_linf",
                   ef_dtype: str = "bfloat16", multi_pod: bool = False):
    """The strategy a `train` combo traces, the reference's for the
    layout (`repro.launch.dryrun.run_combo`), per-leaf exchange: `dp`,
    the workers over the data ranks; `fsdp`, the workers the pods (worker
    axes `()` on one pod, `('pod',)` under the vmap step with exchange
    `sim` on two). Spans on, for the per-phase split."""
    from repro_torch.launch.mesh import worker_axes_for
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Observability, Strategy)
    axes = worker_axes_for(layout, multi_pod)
    if layout == "dp":
        axes = ("data",)     # the port's workers span 'pod' × 'data'
    vmap = layout == "fsdp" and multi_pod
    return Strategy(
        compression=Compression(compressor=compressor, plan="none",
                                ef_dtype=ef_dtype),
        exchange=ExchangePlan(kind="sim" if vmap else exchange,
                              worker_axes=axes,
                              spmd="vmap" if vmap else "shard_map"),
        observability=Observability(spans=True))


def _meta_launches() -> dict:
    """The kernels' meta-launch counters (`kernels.meta`; B5's abstract
    form, `kernels.ssd`), by kernel."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd as SSD
    return {"quantize_ef": Q.meta_launches,
            "quantize_ef_dyn": Q.meta_launches_dyn,
            "paged_attention": FA.meta_launches,
            "flash_attention": FA.flash_meta_launches,
            "ssd_chunked": SSD.ssd_meta_launches,
            "ssd_chunked_bwd": SSD.ssd_bwd_meta_launches}


def _traced(fn, *args, **kwargs):
    """(`op_analysis.analyze(fn, *args, **kwargs)`'s totals and phases,
    with the kernels' meta launches the call made; the call's result)."""
    from repro_torch.launch.op_analysis import analyze
    before = _meta_launches()
    res = analyze(fn, *args, **kwargs)
    out = {k: res[k] for k in ("calls", "flops", "traffic_result_bytes",
                               "held_bytes", "peak_bytes", "phases")}
    out["kernels_meta"] = {k: v - before[k]
                           for k, v in _meta_launches().items()}
    return out, res["result"]


def _nbytes(tree) -> int:
    from repro_torch import tree as T
    return int(sum(x.numel() * x.element_size() for x in T.leaves(tree)
                   if x is not None))


def _max_seq(cfg, shape):
    return shape.seq_len if not cfg.use_rope else 8


def _meta_params(cfg, shape, mesh=None):
    from repro_torch.launch import specs as S
    from repro_torch.models import build
    return build(cfg, mesh).init(device=S.META, max_seq=_max_seq(cfg, shape))


def trace_train(cfg, shape, strategy, *, ranks: int = 1, model: int = 1,
                optimizer: str = "omd", extrapolation: str = "local",
                lr: float = 1e-4, message: str = "update",
                layout: str = "dp", pods: int = 1) -> dict:
    """One rank's `DQGAN.step` of `cfg` under `strategy` on `ranks` ranks
    with a model axis of `model` (layout `dp`: ranks / model workers, one
    a data rank; layout `fsdp`: `pods` pods, a worker each, over which a
    rank's parameters are cut over 'data' and 'model'; one worker on its
    own device when `ranks` is 1), on the meta device, over the global
    batch of `shape`: the op analysis, the kernels' meta launches, the
    collectives the rank issues (the exchange's, and the model group's
    and the fsdp group's apart) and the strategy's `CommLedger`."""
    from repro_torch import tree as T
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import meta_mesh
    from repro_torch.models import build, param_specs
    from repro_torch.parallel import fsdp as FS
    from repro_torch.parallel import tensor as TP

    dq = cfgs.DQConfig.from_strategy(strategy, optimizer=optimizer, lr=lr,
                                     message=message,
                                     extrapolation=extrapolation)
    workers = pods if layout == "fsdp" else ranks // model
    mesh = (meta_mesh(ranks, model=model, layout=layout, pods=pods)
            if ranks > 1 else None)
    bundle = build(cfg, mesh)
    trainer = DQGAN(field_fn=bundle.field_fn, dq=dq, device=S.META,
                    workers=workers, mesh=mesh,
                    param_specs=param_specs(cfg, mesh,
                                            _max_seq(cfg, shape)))
    state = trainer.init(_meta_params(cfg, shape, mesh))
    batch, _ = S.train_batch_specs(cfg, shape, {"data": workers})
    out, _ = _traced(trainer.step, state, batch)
    out["collectives"] = dict(getattr(trainer.worker_backend,
                                      "collectives", {}))
    group = TP.model_group_for(mesh)
    out["collectives_model"] = dict(getattr(group, "collectives", {}))
    out["collectives_fsdp"] = dict(getattr(FS.fsdp_group_for(mesh),
                                           "collectives", {}))
    out["model_axis"] = model
    out["param_bytes_per_rank"] = int(sum(
        x.numel() * x.element_size() for x in T.leaves(state.params)))
    led = trainer.comm_ledger(state.params).summary()
    out["ledger"] = {k: led[k] for k in (
        "wire_bytes_per_step", "carried_bytes_per_step",
        "raw_bytes_per_step", "compression_ratio", "n_entries",
        "n_fallbacks")}
    out["n_workers"] = trainer.n_workers
    out["strategy"] = strategy.describe()
    return out


def _serving(cfg, shape, ranks, model, layout, pods):
    """(the sharded bundle over one rank of `ranks` with a model axis of
    `model` under `layout`, its meta parameters, its mesh)."""
    from repro_torch.launch.mesh import meta_mesh
    from repro_torch.models import build
    if model < 2:
        raise ValueError(f"prefill and decode trace a rank of a model axis "
                         f"above 1, got {model}")
    mesh = meta_mesh(ranks, model=model, layout=layout, pods=pods)
    return build(cfg, mesh), _meta_params(cfg, shape, mesh), mesh


def _serving_record(out, params, caches, mesh) -> dict:
    from repro_torch.parallel import fsdp as FS
    from repro_torch.parallel import tensor as TP
    out["collectives_model"] = dict(getattr(TP.model_group_for(mesh),
                                            "collectives", {}))
    out["collectives_fsdp"] = dict(getattr(FS.fsdp_group_for(mesh),
                                           "collectives", {}))
    out["model_axis"] = mesh.model
    out["param_bytes_per_rank"] = _nbytes(params)
    out["cache_bytes_per_rank"] = _nbytes(caches)
    return out


def trace_prefill(cfg, shape, batch: int, *, ranks: int, model: int,
                  kv_layout: str = "hd_model", max_len: int = 0,
                  layout: str = "dp", pods: int = 1) -> dict:
    """`prefill` of `batch` sequences of `shape.seq_len` tokens on one
    rank's meta parameter shards (a model axis of `model` over `ranks`
    ranks, under `layout`), filling the rank's part of the cache under
    `kv_layout` (`max_len` positions reserved where longer); no
    autograd."""
    from repro_torch.launch import specs as S
    local = dataclasses.replace(shape, global_batch=batch)
    (tokens, enc), _ = S.prefill_input_specs(cfg, local, {})
    bundle, params, mesh = _serving(cfg, shape, ranks, model, layout, pods)
    with torch.no_grad():
        out, (_, caches) = _traced(bundle.prefill, params, tokens, enc,
                                   max_len=max_len, kv_layout=kv_layout)
    return _serving_record(out, params, caches, mesh)


def trace_decode(cfg, shape, batch: int, *, ranks: int, model: int,
                 kv_layout: str = "hd_model", layout: str = "dp",
                 pods: int = 1) -> dict:
    """One `decode_step` of `batch` rows against the rank's part of dense
    caches of `shape.seq_len` (`init_cache` under `kv_layout`) on one
    rank's meta parameter shards (under `layout`); no autograd."""
    from repro_torch.launch import specs as S
    bundle, params, mesh = _serving(cfg, shape, ranks, model, layout, pods)
    caches = bundle.init_cache(batch, shape.seq_len, device=S.META,
                               kv_layout=kv_layout)
    tokens = torch.empty((batch, 1), dtype=torch.int32, device=S.META)
    with torch.no_grad():
        out, _ = _traced(bundle.decode_step, params, tokens, caches)
    return _serving_record(out, params, caches, mesh)


def cache_bytes_per_device(cfg, shape, mesh, kv_layout: str) -> dict:
    """Bytes of one device's part of the decode cache that `shape`'s
    prefill fills or its decode reads (the global batch, `seq_len`
    positions; a windowed model's rolling window), under the JAX
    package's `cache_specs` on `mesh`."""
    from repro_torch import tree as T
    from repro_torch.launch import specs as S
    from repro_torch.models import build
    from repro_torch.parallel import sharding as shd
    B = shape.global_batch
    caches = build(cfg).init_cache(
        B, max(shape.seq_len, cfg.attention_window), device=S.META)
    specs = shd.cache_specs(caches, mesh, B, kv_layout)
    paths, leaves = T.flatten(caches)
    total = sum(math.prod(shd.local_shape(tuple(x.shape), sp, mesh))
                * x.element_size()
                for x, sp in zip(leaves, T.flatten_up_to(paths, specs))
                if x is not None)
    return {"bytes": int(total), "kv_layout": kv_layout, "mesh": dict(mesh),
            "of": "the JAX package's cache_specs, its 'model' axis "
                  "included"}


def param_bytes_per_device(cfg, layout: str, mesh, max_seq: int) -> dict:
    """Bytes of one device's parameter shards under the JAX package's
    `layout` on `mesh` (its 'model' axis included); `max_seq` is the
    length of a learned position table, as the traced params take it."""
    from repro_torch import tree as T
    from repro_torch.launch import specs as S
    from repro_torch.parallel import sharding as shd
    params, specs = S.abstract_params(cfg, mesh, layout, max_seq)
    paths, leaves = T.flatten(params)
    total = sum(math.prod(shd.local_shape(tuple(w.shape), sp, mesh))
                * w.element_size()
                for w, sp in zip(leaves, T.flatten_up_to(paths, specs)))
    return {"bytes": int(total), "layout": layout, "mesh": dict(mesh),
            "of": "the JAX package's layout, its 'model' axis included"}


# --------------------------------------------------------------------------- #
def run_combo(arch: str, shape_name: str, multi_pod: bool, *,
              exchange: str = "two_phase", compressor: str = "qsgd8_linf",
              optimizer: str = "omd", extrapolation: str = "local",
              layout: str = "auto", out_path: str = None, tag: str = "",
              moe_dispatch: str = "", remat: str = "",
              ef_dtype: str = "bfloat16", kv_layout: str = "hd_model",
              mesh_override: str = "", quiet: bool = False) -> dict:
    from repro_torch.launch.mesh import production_mesh_shape, worker_axes_for
    from repro_torch.parallel import sharding as shd

    cfg = cfgs.get(arch)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=moe_dispatch))
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = cfgs.SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "exchange": exchange, "compressor": compressor,
        "optimizer": optimizer, "layout": layout, "tag": tag,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if not ok:
        rec.update(status="skip", reason=reason)
        return _finish(rec, out_path, quiet)

    if layout == "auto":
        layout = "fsdp" if cfg.param_count() > 10e9 else "dp"
        rec["layout"] = layout
    t0 = time.time()
    try:
        mesh = production_mesh_shape(multi_pod, mesh_override)
        if mesh_override:
            rec["mesh"] = mesh_override.replace(",", "x")
        n_chips = math.prod(mesh.values())
        rec["chips"] = rec["ranks"] = n_chips
        rec["worker_axes_reference"] = list(worker_axes_for(layout,
                                                            multi_pod))
        rec["param_bytes_per_device"] = param_bytes_per_device(
            cfg, layout, mesh, _max_seq(cfg, shape))
        B = shape.global_batch
        local = shd.local_shape((B,), shd.batch_spec(mesh, B), mesh)[0]
        # the production mesh, laid out as the reference lays the combo
        # out: its model axis, and under fsdp its pods
        model = mesh.get("model", 1)
        pods = mesh.get("pod", 1) if layout == "fsdp" else 1
        if shape.kind == "train":
            strat = train_strategy(layout, exchange=exchange,
                                   compressor=compressor, ef_dtype=ef_dtype,
                                   multi_pod=multi_pod)
            if layout == "fsdp" and multi_pod:
                rec["exchange"] = "sim(vmap)"
            rec.update(trace_train(cfg, shape, strat, ranks=n_chips,
                                   model=model, optimizer=optimizer,
                                   extrapolation=extrapolation,
                                   layout=layout, pods=pods))
        else:
            trace = (trace_prefill if shape.kind == "prefill"
                     else trace_decode)
            rec["kv_layout"] = kv_layout
            rec["batch_per_rank"] = local
            rec.update(trace(cfg, shape, local, ranks=n_chips, model=model,
                             kv_layout=kv_layout, layout=layout, pods=pods))
            rec["cache_bytes_per_device"] = cache_bytes_per_device(
                cfg, shape, mesh, kv_layout)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["fits"] = rec["peak_bytes"] <= HBM_BYTES
        rec["mf"] = model_flops(cfg, shape)
        rec["analytic_flops"] = analytic_flops(cfg, shape)
        carried = rec.get("ledger", {}).get("carried_bytes_per_step", 0)
        rec["roofline"] = {
            "compute_s": rec["flops"] / PEAK_FLOPS,
            "memory_s": rec["traffic_result_bytes"] / HBM_BW,
            "collective_s": carried / NIC_BW,
        }
        dom = max(rec["roofline"], key=rec["roofline"].get)
        rec["bottleneck"] = dom.replace("_s", "")
        rec["constants"] = CONSTANTS
        rec["status"] = "ok"
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   elapsed_s=round(time.time() - t0, 2))
    return _finish(rec, out_path, quiet)


def summary_line(rec: dict) -> dict:
    return {k: rec.get(k) for k in ("arch", "shape", "mesh", "status",
                                    "bottleneck", "peak_bytes", "fits",
                                    "trace_s", "reason", "error")}


def _finish(rec, out_path, quiet=False):
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    if not quiet:
        print(json.dumps(summary_line(rec)), flush=True)
    return rec


# --------------------------------------------------------------------------- #
def all_combos(mesh_arg: str):
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[mesh_arg]
    for arch in list(cfgs.ASSIGNED) + ["gemma-2b-swa"]:
        for sh in SHAPE_NAMES:
            for mp in meshes:
                yield arch, sh, mp


def _combo_name(arch, shape, mesh, tag):
    name = f"{arch}__{shape}__{mesh}"
    return name + (f"__{tag}" if tag else "")


def _combo_kwargs(args) -> dict:
    return dict(exchange=args.exchange, compressor=args.compressor,
                optimizer=args.optimizer, extrapolation=args.extrapolation,
                layout=args.layout, tag=args.tag,
                moe_dispatch=args.moe_dispatch, remat=args.remat,
                ef_dtype=args.ef_dtype, kv_layout=args.kv_layout,
                mesh_override=args.mesh_override)


def _run_one(job):
    arch, sh, mp, path, kw = job
    return run_combo(arch, sh, mp, out_path=path, **kw)["status"]


def sweep(args):
    """Every combo of `--mesh` not already done in `--outdir` (an ok or
    skip record there), in this process, or over `--jobs` processes."""
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    combos = list(all_combos(args.mesh))
    todo = []
    for arch, sh, mp in combos:
        path = os.path.join(outdir, _combo_name(
            arch, sh, "multi" if mp else "single", args.tag) + ".json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skip"):
                    continue
        todo.append((arch, sh, mp, path, _combo_kwargs(args)))
    print(f"{len(combos)} combos, {len(todo)} to run", flush=True)
    if args.jobs > 1 and len(todo) > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs) as pool:
            pool.map(_run_one, todo, chunksize=1)
    else:
        for job in todo:
            _run_one(job)
    counts = {"ok": 0, "skip": 0, "error": 0}
    for fn in sorted(os.listdir(outdir)):
        if fn.endswith(".json"):
            with open(os.path.join(outdir, fn)) as f:
                st = json.load(f).get("status")
            if st in counts:
                counts[st] += 1
    print(f"done: ok={counts['ok']} skip={counts['skip']} "
          f"error={counts['error']}")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Trace every (arch x input shape) of the port on the "
                    "meta device at published widths: FLOPs, bytes, peak "
                    "memory of one rank, collectives and an H100 roofline.")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--exchange", default="two_phase")
    ap.add_argument("--compressor", default="qsgd8_linf")
    ap.add_argument("--optimizer", default="omd")
    ap.add_argument("--extrapolation", default="local")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "dp", "fsdp"])
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes for --all (default: this one)")
    ap.add_argument("--lower-only", action="store_true",
                    help="refused: the port traces eagerly, there is no "
                         "lowering apart from the trace")
    ap.add_argument("--moe-dispatch", default="")
    ap.add_argument("--remat", default="")
    ap.add_argument("--ef-dtype", default="bfloat16")
    ap.add_argument("--kv-layout", default="hd_model",
                    choices=["hd_model", "seq_model"])
    ap.add_argument("--mesh-override", default="")
    args = ap.parse_args(argv)
    if args.lower_only:
        ap.error("--lower-only has no eager meaning: the port runs no "
                 "compiler, and its trace is the whole dry-run")
    if args.all:
        counts = sweep(args)
        return 1 if counts["error"] else 0
    if not args.arch or not args.shape:
        ap.error("give --arch and --shape, or --all")
    if args.mesh == "both":
        ap.error("--mesh both is for --all; give single or multi")
    out = args.out
    if out is None:
        out = os.path.join(args.outdir, _combo_name(
            args.arch, args.shape, args.mesh, args.tag) + ".json")
    rec = run_combo(args.arch, args.shape, args.mesh == "multi",
                    out_path=out, **_combo_kwargs(args))
    return 1 if rec["status"] == "error" else 0


if __name__ == "__main__":
    raise SystemExit(main())
