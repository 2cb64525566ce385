"""A cell is added by files and an entry alone: a scratch copy of the
checkout gains a tiny configuration, traffic file and limits for each
configuration, and each becomes a runnable cell, no file of `bench/`
edited."""
import json
import subprocess
import sys

import pytest

from bench.tests.tiny import ROOT, SIZES, make_root

DRIVE = """
import json, sys, time
sys.path[:0] = ['.', 'src']
from pathlib import Path
from bench import cell, spec
res, err = cell.run(spec.load_cell(sys.argv[1], Path('.')), 2**31 + 77,
                    0.3, bool(int(sys.argv[2])), 'cpu', time.perf_counter(),
                    log=lambda s: None)
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    return d, make_root(d, dtype="float32")


def test_no_file_edited(root):
    d, _ = root
    for p in (ROOT / "bench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert (d / p.relative_to(ROOT)).read_bytes() == p.read_bytes()


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_runs(root, name, trace):
    d, cells = root
    out = subprocess.run([sys.executable, "-c", DRIVE, cells[name],
                          str(trace)], cwd=d, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["count"] == 1
    if not trace:
        # no peak memory on the CPU
        assert set(res["metrics"]) == {"step_ms", "setup_s"}
    else:
        assert "breakdown" in res


def test_run_refuses_without_a_card(tmp_path):
    make_root(tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "mamba2-1.3b.tiny.train", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_refuses_without_the_program(tmp_path):
    make_root(tmp_path)
    (tmp_path / "src").unlink()
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "mamba2-1.3b.tiny.train", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("change", ["traffic_key", "strategy_key", "chips"])
def test_a_knob_the_harness_does_not_read_is_refused(tmp_path, change):
    """A traffic file with a key that no code reads, or a cell of more
    chips than the harness runs, is refused, not run as one worker on
    one card under the new cell's name."""
    from bench import spec
    cells = make_root(tmp_path)
    name = cells["mamba2-1.3b"]
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    wl = tmp_path / "bench/workloads/tiny.json"
    traffic = json.loads(wl.read_text())
    if change == "traffic_key":
        traffic["workers"] = 4
    elif change == "strategy_key":
        traffic["strategy"]["exchange"] = "sim"
    else:
        for w in bench["workloads"]:
            if w["name"] == name:
                w["chips"] = 4
    wl.write_text(json.dumps(traffic))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SystemExit):
        spec.load_cell(name, tmp_path)
    if change == "chips":
        # the other tiny cell, of one chip, still loads
        spec.load_cell(cells["starcoder2-7b.l4"], tmp_path)
