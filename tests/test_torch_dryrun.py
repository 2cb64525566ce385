"""Port parity of the launch tooling: the dry-run's configs and pure
functions (`repro_torch.launch.dryrun`, `repro_torch.configs`) against
`repro.launch.dryrun` and `repro.configs` for all 11 archs x 4 shapes, the
op analysis (`repro_torch.launch.op_analysis`) of a meta trace against a
CPU trace of the same step, the meta backend of the workers, the kernels'
meta forms, and `run_combo` and its CLI at a reduced config.

Tolerances: the FLOP formulas to rel 1e-12; everything else exactly (op
counts, FLOPs, result bytes and peak live bytes of a trace are integers
that the meta and the CPU trace must share).
"""
import dataclasses
import importlib
import json
import math
import os

import jax
import pytest
import torch

import repro.configs as jcfgs
from repro_torch import configs as tcfgs
from repro_torch.configs import DQConfig
from repro_torch.core import exchange as X
from repro_torch.core.dqgan import DQGAN
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import quantize as Q
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import meta_mesh
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.strategy import (Compression, ExchangePlan, Observability,
                                  Strategy)
from torch_ranks import one_thread  # noqa: F401 (autouse)

ARCHS = list(jcfgs.ASSIGNED) + ["gemma-2b-swa"]
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
META = torch.device("meta")


def _ref_dryrun():
    """`repro.launch.dryrun`, imported without its XLA_FLAGS reaching this
    process's backend (up already) or its subprocesses (restored)."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# --------------------------------------------------------------------------- #
# configs and pure functions
# --------------------------------------------------------------------------- #
def test_configs_equal_the_reference():
    assert tcfgs.ASSIGNED == jcfgs.ASSIGNED
    assert {k: dataclasses.astuple(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcfgs.SHAPES.items()}
    for arch in ARCHS:
        t, j = tcfgs.get(arch), jcfgs.get(arch)
        assert t.active_param_count() == j.active_param_count(), arch
        assert t.param_count() == j.param_count(), arch
        assert t.supports_long_context == j.supports_long_context, arch
        r = t.reduced()
        assert r.active_param_count() == j.reduced().active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_pure_functions_equal_the_reference(arch):
    ref = _ref_dryrun()
    t, j = tcfgs.get(arch), jcfgs.get(arch)
    for name in SHAPE_NAMES:
        ts, js = tcfgs.SHAPES[name], jcfgs.SHAPES[name]
        for fn in ("model_flops", "attention_flops", "analytic_flops"):
            a, b = getattr(dryrun, fn)(t, ts), getattr(ref, fn)(j, js)
            assert a == pytest.approx(b, rel=1e-12, abs=0), (arch, name, fn)
        assert dryrun.applicable(t, ts) == ref.applicable(j, js)


def test_long_500k_skips_the_pure_full_attention_archs():
    skip = {a for a in ARCHS if not dryrun.applicable(
        tcfgs.get(a), tcfgs.SHAPES["long_500k"])[0]}
    assert skip == {"gemma-2b", "starcoder2-7b", "yi-34b", "chameleon-34b",
                    "command-r-plus-104b", "qwen3-moe-30b-a3b",
                    "arctic-480b", "whisper-tiny"}


# --------------------------------------------------------------------------- #
# the op analysis
# --------------------------------------------------------------------------- #
def _lm_trainer(arch, device, compressor="qsgd8_linf", ranks=1, exchange=None,
                plan="none"):
    cfg = tcfgs.get(arch).reduced()
    bundle = build(cfg)
    strat = Strategy(
        compression=Compression(compressor=compressor, plan=plan),
        exchange=ExchangePlan(kind=exchange or "sim",
                              worker_axes=("data",) if ranks > 1 else ()),
        observability=Observability(spans=True))
    dq = DQConfig.from_strategy(strat, optimizer="omd", lr=1e-3,
                                message="update")
    tr = DQGAN(field_fn=bundle.field_fn, dq=dq, device=device,
               workers=ranks, mesh=meta_mesh(ranks) if ranks > 1 else None)
    gen = None if device == META else torch.Generator().manual_seed(0)
    state = tr.init(bundle.init(generator=gen, device=device, max_seq=16))
    B, S = 2 * ranks, 16
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(1)
                              ).to(device) for k in ("tokens", "targets")}
    return tr, state, batch


def _same_analysis(a, b):
    for k in ("ops", "phases", "calls", "flops", "traffic_result_bytes",
              "held_bytes", "peak_bytes"):
        assert a[k] == b[k], (k, a[k], b[k])


def test_meta_trace_equals_the_cpu_trace_op_for_op():
    """A reduced gemma-2b DQGAN step: the meta trace and the CPU trace of
    the same step agree on every op's calls, FLOPs and result bytes, on
    the phases and on the peak of live bytes."""
    # the model's host constants are made once a process (the bf16 GELU
    # constants); make them before either trace
    L._gelu_constants(torch.float32)
    tr, st, batch = _lm_trainer("gemma-2b", torch.device("cpu"))
    cpu = OA.analyze(tr.step, st, batch)
    tr, st, batch = _lm_trainer("gemma-2b", META)
    meta = OA.analyze(tr.step, st, batch)
    _same_analysis(meta, cpu)
    assert meta["flops"] > 0 and meta["peak_bytes"] > meta["held_bytes"] > 0
    assert set(meta["phases"]) == {"(none)", "field", "compress",
                                   "exchange", "apply"}
    for k in ("calls", "flops", "result_bytes"):
        assert sum(p[k] for p in meta["phases"].values()) == \
            sum(o[k] for o in meta["ops"].values()), k
    assert sum(p["calls"] for p in meta["phases"].values()) == meta["calls"]
    assert sum(p["result_bytes"] for p in meta["phases"].values()) == \
        meta["traffic_result_bytes"]
    assert meta["phases"]["field"]["flops"] == meta["flops"]


@pytest.mark.parametrize("arch,exchange", [("qwen3-moe-30b-a3b", "two_phase"),
                                           ("mamba2-1.3b", "allgather"),
                                           ("whisper-tiny", "sim")])
def test_meta_cache_changes_no_record(arch, exchange, monkeypatch):
    """The meta trace's remade outputs give the records of calling every
    op: one rank of four on a meta mesh, with and without the cache."""
    tr, st, batch = _lm_trainer(arch, META, ranks=4, exchange=exchange)
    if arch == "whisper-tiny":
        cfg = tcfgs.get(arch).reduced()
        batch["enc_embeds"] = torch.empty((8, cfg.encdec.enc_seq,
                                           cfg.d_model), device=META)
    tr.step(st, batch)       # what a trainer makes once (device fills)
    cached = OA.analyze(tr.step, st, batch)
    monkeypatch.setattr(OA, "_cacheable", lambda func: False)
    called = OA.analyze(tr.step, st, batch)
    _same_analysis(cached, called)
    kinds = tr.worker_backend.collectives
    assert kinds["all_reduce"]["count"] > 0
    if exchange == "two_phase":
        assert set(kinds) >= {"all_to_all", "all_gather"}


def test_block1024_traces_b1_as_one_op():
    """Under a *_block1024 plan the meta step runs B1's abstract form once
    (one `repro_torch.quantize_ef` op with its outputs), where the CPU
    step runs its plain version."""
    Q.reset_launches()
    tr, st, batch = _lm_trainer("gemma-2b", META, "qsgd8_block1024",
                                plan="uniform")
    res = OA.analyze(tr.step, st, batch)
    assert Q.meta_launches == 1 and Q.launches == 0
    assert res["ops"]["repro_torch.quantize_ef.default"]["calls"] == 1
    assert res["phases"]["compress"]["calls"] >= 1
    tr, st, batch = _lm_trainer("gemma-2b", torch.device("cpu"),
                                "qsgd8_block1024", plan="uniform")
    res = OA.analyze(tr.step, st, batch)
    assert Q.meta_launches == 1
    assert "repro_torch.quantize_ef.default" not in res["ops"]


def test_meta_workers_match_the_process_group_shapes():
    """Each collective of `MetaWorkers` gives the shape (and dtype) that
    `ProcessGroupWorkers` returns on the same rank, i.e. the rank's rows of
    the stacked result, and refuses a non-meta operand."""
    W, world = 8, 4
    stacked = X.StackedWorkers(W)
    meta = X.workers_for(meta_mesh(world, rank=1), W)
    assert isinstance(meta, X.MetaWorkers)
    L_ = meta.n_local
    assert (meta.offset, L_) == (2, 2)
    g = torch.zeros((W, 64))
    local = torch.empty((L_, 64), device=META)
    assert meta.mean(local).shape == stacked.mean(g).shape
    assert meta.all_gather(local).shape == stacked.all_gather(g).shape
    assert meta.reduce_scatter(local).shape == \
        stacked.reduce_scatter(g)[2:4].shape
    a2a = torch.empty((L_, W, 3), device=META)
    assert meta.all_to_all(a2a).shape == \
        stacked.all_to_all(torch.zeros((W, W, 3)))[2:4].shape
    assert set(meta.collectives) == {"all_reduce", "all_gather",
                                     "reduce_scatter", "all_to_all"}
    assert meta.collectives["all_gather"]["bytes"] == W * 64 * 4
    with pytest.raises(ValueError, match="meta"):
        meta.mean(torch.zeros((L_, 64)))


# --------------------------------------------------------------------------- #
# the kernels' meta forms
# --------------------------------------------------------------------------- #
def _refuse(*a, **k):
    raise AssertionError("a meta call reached the plain version or the card")


def test_kernel_wrappers_on_meta_operands(monkeypatch):
    """Meta operands: the kernels' output shapes and dtypes, one meta
    launch each, and neither the plain version nor the CUDA path."""
    from repro_torch.kernels import _build
    for name in ("quantize_ef_ref", "_launch"):
        monkeypatch.setattr(Q, name, _refuse)
    for name in ("paged_attention_ref", "flash_attention_ref", "_launch",
                 "_flash_launch"):
        monkeypatch.setattr(FA, name, _refuse)
    monkeypatch.setattr(_build, "load", _refuse)
    Q.reset_launches()
    FA.reset_launches()
    g = torch.empty((4, 1024), device=META)
    codes, scale, e = Q.quantize_ef_blocked(g, g, g, levels=127)
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in
            (codes, scale, e)] == [((4, 1024), torch.int8, "meta"),
                                   ((4, 1), torch.float32, "meta"),
                                   ((4, 1024), torch.float32, "meta")]
    lv = torch.empty((1,), device=META)
    codes, scale, e = Q.quantize_ef_flat(g.reshape(-1), g.reshape(-1),
                                         g.reshape(-1), levels=lv)
    assert (tuple(codes.shape), tuple(scale.shape)) == ((4096,), (4,))
    assert (Q.meta_launches, Q.meta_launches_dyn, Q.launches,
            Q.launches_dyn) == (1, 1, 0, 0)
    q = torch.empty((2, 1, 4, 64), dtype=torch.bfloat16, device=META)
    pool = torch.empty((6, 16, 1, 64), dtype=torch.bfloat16, device=META)
    table = torch.empty((2, 3), dtype=torch.int32, device=META)
    lengths = torch.empty((2,), dtype=torch.int32, device=META)
    out = FA.paged_flash_attention(q, pool, pool, table, lengths)
    assert (tuple(out.shape), out.dtype) == ((2, 1, 4, 64), torch.bfloat16)
    x = torch.empty((4, 256, 64), device=META)
    out = FA.flash_attention(x, x, x)
    assert (tuple(out.shape), out.dtype, out.device.type) == \
        ((4, 256, 64), torch.float32, "meta")
    assert (FA.meta_launches, FA.flash_meta_launches, FA.launches,
            FA.flash_launches) == (1, 1, 0, 0)
    with pytest.raises(ValueError):       # a meta call takes meta operands
        Q.quantize_ef_blocked(g, torch.zeros((4, 1024)), g)
    with pytest.raises(TypeError):        # and the kernel's dtypes
        Q.quantize_ef_blocked(g.to(torch.bfloat16), g, g)
    Q.reset_launches()
    FA.reset_launches()


# --------------------------------------------------------------------------- #
# run_combo and the CLI
# --------------------------------------------------------------------------- #
@pytest.fixture
def reduced_configs(monkeypatch):
    get = tcfgs.get
    monkeypatch.setattr(tcfgs, "get", lambda name: get(name).reduced())


@pytest.mark.parametrize("arch,shape,layout,exchange", [
    ("gemma-2b", "train_4k", "dp", "sim"),
    ("qwen3-moe-30b-a3b", "train_4k", "fsdp", "exact"),
    ("mamba2-1.3b", "prefill_32k", "auto", "two_phase"),
    ("recurrentgemma-2b", "long_500k", "auto", "two_phase"),
    # the mixers and the encoder-decoder at model 16
    ("mamba2-1.3b", "train_4k", "dp", "sim"),
    ("recurrentgemma-2b", "train_4k", "dp", "two_phase"),
    ("whisper-tiny", "train_4k", "dp", "sim")])
def test_run_combo_at_a_reduced_config(arch, shape, layout, exchange,
                                       reduced_configs):
    rec = dryrun.run_combo(arch, shape, False, exchange=exchange,
                           layout=layout, quiet=True)
    assert rec["status"] == "ok", rec.get("error")
    rf = rec["roofline"]
    assert all(math.isfinite(v) and v > 0 for k, v in rf.items()
               if k != "collective_s" or shape == "train_4k"), rf
    assert rec["bottleneck"] == max(rf, key=rf.get).replace("_s", "")
    assert rec["ranks"] == 256 and rec["peak_bytes"] > rec["held_bytes"]
    assert rec["param_bytes_per_device"]["bytes"] > 0
    if shape == "train_4k":
        assert rec["flops"] >= rec["mf"] / 256   # one rank's share
        # dp: the (16, 16) data x model grid, 16 workers; fsdp: a pure
        # data mesh of 256
        assert rec["n_workers"] == (16 if layout == "dp" else 256)
        assert rec["model_axis"] == (16 if layout == "dp" else 1)
        if layout == "dp":
            assert (rec["param_bytes_per_rank"]
                    == rec["param_bytes_per_device"]["bytes"])
            assert rec["collectives_model"]
        assert rec["ledger"]["wire_bytes_per_step"] > 0
        kinds = set(rec["collectives"])
        assert kinds >= ({"reduce_scatter", "all_gather"} if layout == "fsdp"
                         else {"all_reduce"})


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b",
                                  "whisper-tiny"])
def test_multi_pod_train_splits_its_batch_at_model_16(arch, reduced_configs):
    """The (2·16, 16) fleet of 512 ranks is 32 data ranks, a worker each:
    the global batch of 256 splits 8 rows a rank, and each rank holds the
    JAX layout's bytes of the parameters."""
    rec = dryrun.run_combo(arch, "train_4k", True, exchange="sim",
                           layout="dp", quiet=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["ranks"] == 512 and rec["model_axis"] == 16
    assert rec["n_workers"] == 32
    assert (rec["param_bytes_per_rank"]
            == rec["param_bytes_per_device"]["bytes"])
    assert rec["collectives_model"] and "model_axis_note" not in rec


def test_cli_writes_its_record(tmp_path, capsys):
    out = tmp_path / "rec.json"
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                      "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["status"] == "ok" and rec["fits"] is True
    assert rec["constants"]["peak_flop_s"] == 989e12
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["status"] == "ok" and line["arch"] == "whisper-tiny"
    rc = dryrun.main(["--arch", "yi-34b", "--shape", "long_500k",
                      "--outdir", str(tmp_path)])
    rec = json.loads((tmp_path / "yi-34b__long_500k__single.json")
                     .read_text())
    assert rc == 0 and rec["status"] == "skip"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                     "--lower-only"])
    assert "no eager meaning" in capsys.readouterr().err
