"""Guards of the PyTorch port: it imports neither jax nor the JAX package,
its launcher never falls back to the CPU on its own, it refuses what it
does not run yet, and its CLI trains on the CPU when asked."""
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")

TRAIN = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dcgan32"]


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
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = _run([sys.executable, "-c", script])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20  # every module was imported


def test_no_port_source_names_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro(\.|\s|$)|"
                     r"from repro(\.|\s))", re.M)
    hits = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    hits += [(path, m.group(0)) for m in
                             pat.finditer(fh.read())]
    assert not hits, hits


def test_cli_without_a_gpu_refuses_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _run(TRAIN + ["--steps", "1"])
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert not out.stdout.strip().startswith("{")


@pytest.mark.parametrize("flags,slice_", [
    (["--schedule", "local_k", "--local-k", "2"], "slice 3"),
    (["--participation", "0.5"], "slice 2"),
    (["--preset", "fsdp_zero3"], "slice 5"),
    (["--obs-metrics", "wire"], "slice 4"),
    (["--straggler-profile", "mild"], "slice 3"),
])
def test_cli_refuses_unported_features(flags, slice_):
    out = _run(TRAIN + ["--device", "cpu", "--steps", "1"] + flags)
    assert out.returncode == 2
    assert "ROADMAP" in out.stderr and slice_ in out.stderr


@pytest.mark.parametrize("name,ported", [
    ("paper_dqgan", True), ("exact_baseline", True),
    ("quantized_no_ef", True), ("byte_budget", True),
    ("low_bandwidth", False), ("adaptive_budget", False),
    ("overlap", False), ("ssp_server", False),
    ("partial_participation", False), ("fsdp_vmap", False),
    ("fsdp_zero2", False), ("fsdp_zero3", False),
])
def test_trainer_runs_or_refuses_each_preset(name, ported):
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.strategy import get_preset
    if ported:
        DQGAN(field_fn=None, strategy=get_preset(name), device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DQGAN(field_fn=None, strategy=get_preset(name), device="cpu")


def test_cli_trains_on_the_cpu_when_asked():
    out = _run(TRAIN + ["--device", "cpu", "--steps", "3", "--compressor",
                        "qsgd8_block1024", "--comm-plan", "uniform"])
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        for k in ("loss", "grad_norm", "error_norm", "wire_mb_step",
                  "cum_wire_mb", "comm_ratio", "step_s"):
            assert math.isfinite(r[k]), (k, r)
    assert "3 buckets (1849988 elems, 0.1% pad)" in out.stdout
