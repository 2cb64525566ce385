"""Guards of the PyTorch port: neither it nor `chip_smoke.py` imports jax
or the JAX package, its launchers never fall back to the CPU on their own,
they refuse what the port does not run yet (and train what it now runs:
overlap, ssp_server, observability), the training CLI trains on the CPU when asked, with
one worker or several, and the serving CLI serves gemma-2b there."""
import functools
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch
from torch_ranks import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
JAX_OR_REPRO = re.compile(r"^\s*(import jax|from jax|import repro(\.|\s|$)|"
                          r"from repro(\.|\s))", re.M)

TRAIN = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dcgan32"]
SERVE = [sys.executable, "-m", "repro_torch.launch.serve"]


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def test_port_imports_neither_jax_nor_repro():
    script = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(sorted(m for m in sys.modules if "
        "m.startswith('repro_torch')))\n"
        "assert not bad, bad\n")
    out = _run([sys.executable, "-c", script])
    assert out.returncode == 0, out.stderr
    walked = eval(out.stdout.splitlines()[-1])
    assert len(walked) > 30  # every module was imported
    for mod in ("serve.engine", "serve.kv_cache", "serve.baseline",
                "launch.serve", "models.model", "kernels.flash_attention",
                "optim", "sched.schedule", "sched.server", "sched.clock",
                "sched.straggler", "checkpoint", "gan_common", "quickstart",
                "strategy.__main__", "launch.mesh", "core.exchange", "parity",
                "obs.tracing", "obs.metrics", "obs.sink", "obs.cli",
                "obs.report", "obs.calibrate", "obs.__main__", "obs.profile",
                "obs.trace", "serve.quantized_weights",
                "configs.gemma_2b_swa", "models.moe", "models.registry",
                "configs.starcoder2_7b", "configs.arctic_480b",
                "models.mixers", "configs.mamba2_1_3b",
                "configs.recurrentgemma_2b", "configs.whisper_tiny",
                "launch.dryrun", "launch.specs", "launch.op_analysis",
                "parallel.sharding", "kernels.meta"):
        assert f"repro_torch.{mod}" in walked, mod


# each Pallas kernel of the JAX package: (its kernel function, the port's
# source in kernels._build.SOURCES, the C function the source exports)
TPU_KERNELS = {
    "B1": ("_quantize_ef_kernel", "quantize_ef", "quantize_ef_f32"),
    "B2": ("_quantize_ef_kernel_dyn", "quantize_ef", "quantize_ef_dyn_f32"),
    "B3": ("_paged_kernel", "paged_attention", "paged_attention_bf16"),
    "B4": ("_flash_kernel", "flash_attention", "flash_attention_bf16"),
}


def test_every_tpu_kernel_has_a_cuda_source():
    from repro_torch.kernels import _build
    calls = 0
    for root, _, files in os.walk(os.path.join(SRC, "repro", "kernels")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    calls += fh.read().count("pl.pallas_call(")
    assert calls == len(TPU_KERNELS), "a Pallas kernel is missing here"
    for tag, (pallas_fn, name, export) in TPU_KERNELS.items():
        src = _build.SOURCES[name]
        assert src.suffix == ".cu" and src.is_file(), (tag, src)
        text = src.read_text()
        assert f"`{pallas_fn}`" in text, (tag, "the note names the kernel")
        assert f'extern "C" int {export}(' in text, (tag, export)


def test_no_port_source_names_jax_or_repro():
    hits = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    hits += [(path, m.group(0)) for m in
                             JAX_OR_REPRO.finditer(fh.read())]
    assert not hits, hits


# the modules of the JAX package whose counterpart in the port has another
# name, or that have none, with the reason
COUNTERPARTS = {
    "obs/hlo.py": ("obs/trace.py", "the port reads a step's collectives "
                   "off a profiler trace: there is no HLO"),
    "launch/hlo_analysis.py": ("launch/op_analysis.py", "the port runs "
                               "eagerly: its costs come from a dispatch "
                               "mode over the traced ops, not an HLO walk"),
    "parallel/compat.py": (None, "JAX API shims across JAX versions; the "
                           "port calls no such API"),
}


def _modules(root):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".py") and "__pycache__" not in d}


def test_every_module_of_the_jax_package_has_a_counterpart():
    """Every `.py` under src/repro has one under src/repro_torch at the
    same relative path, or an entry in COUNTERPARTS that names it (and
    its reason)."""
    ref, port = _modules(os.path.join(SRC, "repro")), _modules(PORT)
    missing = sorted(ref - port - set(COUNTERPARTS))
    assert not missing, f"modules of the JAX package with no counterpart: " \
        f"{missing}"
    for mod, (other, why) in COUNTERPARTS.items():
        assert mod in ref and mod not in port and why, mod
        assert other is None or other in port, (mod, other)


def _spy(monkeypatch, mod, names, hits):
    for name in names:
        real = getattr(mod, name)

        def spy(*a, _name=name, _real=real, **k):
            hits.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)


def _kernel_calls():
    """{tag: (module, plain version, meta form, CUDA launch, call(device))}
    for the four kernels' wrappers."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q

    def b1(dev):
        g = torch.zeros((4, 1024), device=dev)
        Q.quantize_ef_blocked(g, g, g, levels=127)

    def b2(dev):
        g = torch.zeros((4, 1024), device=dev)
        Q.quantize_ef_blocked(g, g, g, levels=torch.full((1,), 7.0,
                                                         device=dev))

    def b3(dev):
        q = torch.zeros((2, 1, 4, 64), device=dev)
        pool = torch.zeros((6, 16, 1, 64), device=dev)
        FA.paged_flash_attention(
            q, pool, pool, torch.zeros((2, 3), dtype=torch.int32, device=dev),
            torch.ones((2,), dtype=torch.int32, device=dev))

    def b4(dev):
        x = torch.zeros((2, 128, 64), device=dev)
        FA.flash_attention(x, x, x)

    return {"B1": (Q, "quantize_ef_ref", "_meta_call", "_launch", b1),
            "B2": (Q, "quantize_ef_ref", "_meta_call", "_launch", b2),
            "B3": (FA, "paged_attention_ref", "_paged_meta", "_launch", b3),
            "B4": (FA, "flash_attention_ref", "_flash_meta", "_flash_launch",
                   b4)}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("tag", ["B1", "B2", "B3", "B4"])
def test_kernel_wrappers_dispatch_by_device(tag, device, monkeypatch):
    """No fallback: a CPU operand goes to the plain version alone, a meta
    operand to the kernel's meta form alone; neither reaches the CUDA
    launch (which a CUDA operand takes, or raises)."""
    mod, plain, meta_form, launch, call = _kernel_calls()[tag]
    hits = []
    _spy(monkeypatch, mod, (plain, meta_form, launch), hits)
    call(torch.device(device))
    assert hits == [plain if device == "cpu" else meta_form]


def test_chip_smoke_names_neither_jax_nor_repro():
    with open(SMOKE) as fh:
        src = fh.read()
    assert not [m.group(0) for m in JAX_OR_REPRO.finditer(src)]
    # and nothing it imports does: run it here, where it must fail on the
    # missing GPU, and list what it loaded
    script = (
        "import runpy, sys\n"
        f"sys.argv = [{SMOKE!r}]\n"
        "try:\n"
        f"    runpy.run_path({SMOKE!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('rc', e.code)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.')))\n")
    out = _run([sys.executable, "-c", script])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    if not torch.cuda.is_available():
        assert lines[-2] != "rc 0" and "ok" not in out.stdout
    assert lines[-1] == "[]", lines[-1]


def test_cli_without_a_gpu_refuses_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _run(TRAIN + ["--steps", "1"])
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert not out.stdout.strip().startswith("{")


def _cli(argv, capsys):
    """The training CLI on dcgan32 in this process (the launcher's own
    `main`: the process boundary is not what these tests check): (its
    rows, what it printed)."""
    capsys.readouterr()
    rows = _main(["--arch", "dcgan32"] + argv)
    return rows, capsys.readouterr().out


def _main(argv):
    """`launch.train.main(argv)` on one intra-op thread: the suite runs
    its files in parallel processes, where every process's default thread
    pool over all the cores would contend for them."""
    from repro_torch.launch import train
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return train.main(argv)
    finally:
        torch.set_num_threads(threads)


def _assert_trains(rows, steps=1):
    """The CLI ran to its end: one finite row a step."""
    assert [r["step"] for r in rows] == list(range(steps))
    for r in rows:
        assert math.isfinite(r["loss"]) and math.isfinite(r["error_norm"])
    return rows


# every feature of the training CLI is ported (slice 3's overlap, slice
# 4's observability, slice 5's vmap and fsdp): none is refused, each trains
@pytest.mark.parametrize("flags", [
    ["--schedule", "delayed", "--overlap"],
    ["--spmd", "vmap"],
    ["--preset", "fsdp_zero3"],
    ["--obs-metrics", "wire"],
    ["--preset", "ssp_server"],
])
def test_cli_trains_each_ported_feature(flags, capsys):
    _assert_trains(_cli(["--device", "cpu", "--steps", "1"] + flags,
                        capsys)[0])


@pytest.mark.parametrize("name", [
    "paper_dqgan", "exact_baseline", "quantized_no_ef", "byte_budget",
    "low_bandwidth", "adaptive_budget", "overlap", "ssp_server",
    "partial_participation", "fsdp_vmap", "fsdp_zero2", "fsdp_zero3"])
def test_trainer_runs_or_refuses_each_preset(name):
    """Every preset constructs a trainer: the port refuses none."""
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.strategy import get_preset
    DQGAN(field_fn=None, strategy=get_preset(name), device="cpu")


def test_cli_trains_on_the_cpu_when_asked(capsys):
    rows, out = _cli(["--device", "cpu", "--steps", "3", "--compressor",
                      "qsgd8_block1024", "--comm-plan", "uniform"], capsys)
    assert rows == [json.loads(line) for line in out.splitlines()
                    if line.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        for k in ("loss", "grad_norm", "error_norm", "wire_mb_step",
                  "cum_wire_mb", "comm_ratio", "step_s"):
            assert math.isfinite(r[k]), (k, r)
    assert "3 buckets (1849988 elems, 0.1% pad)" in out


def _train(argv):
    """The training CLI's rows, in this process."""
    return _main(["--arch", "dcgan32", "--device", "cpu"] + argv)


@functools.lru_cache(maxsize=None)
def _train_rows(argv: tuple):
    """`_train`, once per argv: the uninterrupted run both resume cases
    compare with."""
    return _train(list(argv))


@pytest.mark.parametrize("flags,rounds,staleness", [
    (["--schedule", "local_k", "--local-k", "4"], [0, 0, 0, 0, 1], None),
    (["--schedule", "delayed", "--staleness-tau", "2"], [0, 1, 2, 3, 4],
     2.0),
    (["--schedule", "delayed", "--straggler-profile", "mild"],
     [0, 1, 2, 3, 4], 1.0),
])
def test_cli_trains_each_schedule_on_the_cpu(flags, rounds, staleness):
    """dcgan32 (reduced) under local_k and delayed: rows carry the round
    and the simulated clock, and under delayed the staleness. Chip
    smoke's phase sched runs the full width on the card."""
    rows = _train(["--smoke", "--steps", "5", "--optimizer", "omd",
                   "--compressor", "qsgd8_block1024", "--comm-plan",
                   "uniform"] + flags)
    assert [r["round"] for r in rows] == rounds
    clocks = [r["sim_clock_s"] for r in rows]
    assert clocks == sorted(clocks) and clocks[-1] > 0
    for r in rows:
        assert math.isfinite(r["loss"]) and math.isfinite(r["error_norm"])
        if staleness is None:
            assert "staleness_max" not in r
        else:
            assert r["staleness_max"] == r["staleness_mean"] == staleness


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
def test_cli_resume_continues_the_run(fmt, tmp_path, capsys):
    """--checkpoint after 3 steps, then --resume: the resumed run starts
    at step 3 and its rows equal the uninterrupted run's; a resume under
    another strategy is refused with the field diff."""
    ckpt = str(tmp_path / ("c.npz" if fmt == "npz" else "c"))
    base = ["--smoke", "--optimizer", "omd", "--compressor",
            "qsgd8_block1024", "--comm-plan", "uniform", "--schedule",
            "local_k", "--local-k", "2"]
    full = _train_rows(tuple(base + ["--steps", "6"]))
    _train(base + ["--steps", "3", "--checkpoint", ckpt]
           + ([] if fmt == "npz" else ["--checkpoint-shards", "2"]))
    capsys.readouterr()
    rest = _train(base + ["--steps", "6", "--resume", ckpt])
    assert "# resumed from" in capsys.readouterr().out
    keys = ("step", "round", "loss", "grad_norm", "error_norm")
    assert [r["step"] for r in rest] == [3, 4, 5]
    assert [{k: r[k] for k in keys} for r in rest] == \
        [{k: r[k] for k in keys} for r in full[3:]]
    with pytest.raises(SystemExit, match="schedule.kind"):
        _train(base[:-4] + ["--steps", "6", "--resume", ckpt])


ADAPTIVE = ["--workers", "4", "--batch", "8", "--optimizer", "omd",
            "--compressor", "qsgd8_block1024", "--comm-plan", "delta_budget",
            "--comm-budget-mb", "0.75", "--comm-adaptive",
            "--participation", "0.5"]


# four workers: each ported path trains (vmap, delayed with overlap, fsdp
# zero-3 with its block-1024 all-gather, whose # comm: line bills both
# legs)
@pytest.mark.parametrize("flags", [
    ["--spmd", "vmap"],
    ["--schedule", "delayed", "--overlap"],
    ["--preset", "fsdp_zero3", "--compressor", "qsgd8_block1024",
     "--moment-compressor", "qsgd8_block1024"],
])
def test_cli_trains_four_workers_each_path(flags, capsys):
    rows, out = _cli(["--device", "cpu", "--steps", "1", "--workers", "4",
                      "--batch", "8"] + flags, capsys)
    _assert_trains(rows)
    if "fsdp_zero3" in flags:
        line = next(x for x in out.splitlines()
                    if x.startswith("# comm: fsdp zero-3"))
        assert "reduce-scatter (two_phase, qsgd8_block1024)" in line
        assert f"{rows[0]['wire_mb_step']:.3f} MB" in line


def test_cli_trains_four_workers_adaptive_on_the_cpu(capsys):
    rows, out = _cli(["--device", "cpu", "--steps", "3"] + ADAPTIVE, capsys)
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert r["participants"] == 2
        for k in ("loss", "grad_norm", "error_norm", "wire_mb_step",
                  "cum_wire_mb", "comm_ratio", "step_s"):
            assert math.isfinite(r[k]), (k, r)
    assert "family[4] base=qsgd8_block1024" in out


def test_serve_cli_without_a_gpu_refuses_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _run(SERVE + ["--arch", "gemma-2b", "--smoke"])
    assert out.returncode == 2
    assert "--device cpu" in out.stderr
    assert not out.stdout.strip()


def test_serve_cli_serves_gemma_on_the_cpu_when_asked():
    out = _run(SERVE + ["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                        "--batch", "4", "--prompt-len", "32", "--gen", "8"])
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.splitlines()[-1])
    assert row["arch"] == "gemma-2b-smoke" and row["mode"] == "engine"
    assert row["generated"] == 32 and row["batch"] == 4
    assert row["attn_impl"] == "gather" and row["weights"] == "f32"
    assert len(row["sample_tokens"]) == 8
    assert row["tokens_per_s"] > 0 and row["decode_step_s"] > 0


# quantized weights and gemma-2b-swa are ported (slice 7): what the CLI
# still refuses there is what the JAX package refuses (a compressor that
# is not a linf quantizer, delta_budget without a budget, a windowed
# model in the paged engine)
@pytest.mark.parametrize("flags,slice_", [
    (["--arch", "gemma-2b", "--quantize-weights", "qsgd8_l2"],
     "needs a linf StochasticQuant"),
    (["--arch", "gemma-2b", "--quantize-weights", "qsgd8_linf",
      "--weight-plan", "delta_budget"], "positive per-step byte budget"),
    (["--arch", "whisper-tiny"], "encoder-decoder models are not supported"),
    (["--arch", "gemma-2b-swa"], "sliding-window attention"),
])
def test_serve_cli_refuses_unported_features(flags, slice_):
    out = _run(SERVE + ["--device", "cpu", "--smoke"] + flags)
    assert out.returncode == 2
    assert slice_ in out.stderr and not out.stdout.strip()
