"""`bench/nccl_smoke.py`'s path rehearsed on the CPU: four gloo ranks of
a tiny cell, one worker each, agree on the parameters after their steps
(the common mean update), and their losses are finite."""
import json
import math
import subprocess
import sys

from bench.tests.tiny import make_root


def test_four_ranks_agree(tmp_path):
    cells = make_root(tmp_path, dtype="float32")
    out = subprocess.run(
        [sys.executable, "bench/nccl_smoke.py", "--workload",
         cells["starcoder2-7b.l4"], "--ranks", "4", "--steps", "2",
         "--seed", str(2 ** 31 + 99), "--device-type", "cpu", "--root",
         str(tmp_path), "--timeout", "240"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    ranks = res["per_rank"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["param_gap_between_ranks"] == 0.0
        assert all(math.isfinite(x) for x in r["losses"])
