"""A checkout in a scratch folder with tiny cells of its own, added as
data files and entries alone: the configurations' model objects cut to a
few thousand parameters, one traffic file, limits."""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {
    "starcoder2-7b.l4": dict(num_layers=2, d_model=64, num_heads=4,
                             num_kv_heads=2, head_dim=16, d_ff=128,
                             vocab_size=256, xent_chunk=32),
    "mamba2-1.3b": dict(num_layers=2, d_model=64, vocab_size=256,
                        head_dim=16, xent_chunk=32,
                        ssm={"state_dim": 16, "head_dim": 16, "expand": 2,
                             "conv_width": 4, "chunk_size": 16}),
}


def make_root(dst: Path, dtype: str = "bfloat16", limits=None) -> dict:
    """Copies BENCHMARK.json and bench/ to `dst`, links the program's
    src/, and adds a tiny cell "<config>.tiny" of each configuration in
    `dtype`, with `limits` ({number: limit}; by default the limits of the
    configuration's first real cell). Returns {config: cell name}."""
    dst = Path(dst)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", dst / "src")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    real = {w["config"]: w["name"] for w in bench["workloads"]}
    wl = json.loads((ROOT / "bench/workloads/train.b2x2048.json").read_text())
    wl.update(batch=2, seq=64, batches=6, profile_steps=2)
    wl["strategy"]["bucket_mb"] = 0.01
    (dst / "bench/workloads/tiny.json").write_text(json.dumps(wl))
    cells = {}
    for name, sizes in SIZES.items():
        cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
        cfg["name"] = f"{name}.tiny"
        cfg["model"].update(sizes, param_dtype=dtype)
        (dst / f"bench/configs/{name}.tiny.json").write_text(json.dumps(cfg))
        cell = f"{name}.tiny.train"
        bench["workloads"].append({"name": cell, "config": f"{name}.tiny",
                                   "traffic": "tiny", "chips": 1,
                                   "why": "a test's tiny cell"})
        lim = (json.loads((ROOT / f"bench/limits/{real[name]}.json")
                          .read_text()) if limits is None
               else {k: {"limit": v} for k, v in limits.items()})
        (dst / f"bench/limits/{cell}.json").write_text(json.dumps(lim))
        cells[name] = cell
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return cells
