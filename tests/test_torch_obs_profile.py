"""`repro_torch.obs.profile` and `tracing` on the CPU: the window semantics
and the ``profile`` event of the JAX package's step profiler (its
tests/test_obs_profile.py, ported), the device-phase attribution of a
`torch.profiler` capture of the step, the Chrome trace, the overlap
ratio against the JAX function, and the training CLI end to end: a sink
with a ``profile`` event that ``python -m repro.obs report`` renders."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.obs.profile import (DEFAULT_WINDOW, NullStepProfiler,
                                     StepProfiler, make_profiler,
                                     overlap_ratio, phase_costs)
from repro_torch.obs.tracing import (DEVICE_PHASES, HOST_PHASES, PREFIX,
                                     device_span, host_span)
from torch_ranks import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def test_span_names_match_the_jax_package():
    from repro.obs import tracing as J
    assert (PREFIX, HOST_PHASES, DEVICE_PHASES) == (
        J.PREFIX, J.HOST_PHASES, J.DEVICE_PHASES)
    from contextlib import nullcontext
    assert isinstance(device_span("field", False), nullcontext)
    assert isinstance(host_span("data", False), nullcontext)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with host_span("step"), device_span("field"):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert PREFIX + "step" in names and PREFIX + "field" in names


def test_window_fills_and_closes():
    p = StepProfiler(window=3)
    assert p.active and not p.done
    for i in range(5):                    # 2 extra records are ignored
        p.record_step(10 + i, 1e-3, exchanged=(i % 2 == 0))
    assert p.done
    assert len(p.step_walls) == 3
    assert p.first_step == 10
    assert p.exchange_steps == 2          # steps 10, 12


def test_phase_accumulates_only_while_active():
    p = StepProfiler(window=1)
    with p.phase("data"):
        time.sleep(0.001)
    p.record_step(0, 1e-3)
    with p.phase("data"):                 # window closed: no-op context
        time.sleep(0.001)
    assert p.phase_s["data"][1] == 1
    assert p.phase_s["data"][0] > 0


def test_summary_payload_matches_the_jax_profilers():
    from repro.obs.profile import StepProfiler as J
    walls = [3.0, 2e-3, 3e-3, 4e-3]
    p, j = StepProfiler(window=4), J(window=4)
    for i, w in enumerate(walls):
        p.record_step(i, w)
        j.record_step(i, w)
    assert p.summary() == j.summary()
    assert "device_phases" not in p.summary()
    assert StepProfiler(window=2).summary() is None   # nothing recorded


def test_emit_is_idempotent_and_schema_valid(tmp_path):
    from repro.obs import read_events as jread
    path = str(tmp_path / "prof.jsonl")
    sink = obs.JsonlFileSink(path, strategy_hash="abc")
    p = StepProfiler(window=2)
    p.record_step(0, 1e-3)
    p.record_step(1, 2e-3)
    ev = p.emit(sink)
    assert ev is not None and ev["kind"] == "profile" and ev["v"] == 2
    assert p.emit(sink) is None           # second emit: no-op
    sink.close()
    (read,) = jread(path)                 # the JAX package validates it
    assert read["n_steps"] == 2


def test_invalid_window_and_factory():
    with pytest.raises(ValueError, match="window"):
        StepProfiler(window=0)
    assert isinstance(make_profiler(False), NullStepProfiler)
    on = make_profiler(True)
    assert isinstance(on, StepProfiler) and on.window == DEFAULT_WINDOW
    assert make_profiler(True, window=7).window == 7


def test_null_profiler_surface():
    p = NullStepProfiler()
    with p.phase("step"):
        pass
    p.record_step(0, 1e-3)
    assert p.done and not p.active and p.step_walls == []
    assert p.summary() is None
    assert p.emit(obs.NullSink()) is None
    assert p.device_phase_costs() == {}


@pytest.mark.parametrize("on,off,ex", [
    ([1.0, 2.0, 3.0], [2.0, 4.0, 5.0], None),
    ([1.0], [0.5], 0.2),
    (0.8, 1.0, 0.5),
])
def test_overlap_ratio_matches_the_jax_function(on, off, ex):
    from repro.obs.profile import overlap_ratio as J
    assert overlap_ratio(on, off, ex) == J(on, off, ex)


def _trainer(spans, kind="sim", workers=1):
    from torch_ranks import mixture_case, make_trainer, _torch
    from repro_torch import tree as T
    from repro_torch.strategy import Strategy
    case = mixture_case("sim_full" if kind == "sim" else f"{kind}_full",
                        False, steps=4)
    strat = Strategy.from_json(case["strategy"]).evolve(obs_spans=spans)
    if workers == 1:
        strat = strat.evolve(worker_axes=())
    tr = make_trainer(dict(case, strategy=strat.to_json(), W=workers))
    st = tr.init(T.unflatten(case["paths"],
                             [_torch(x) for x in case["params"]]))
    return tr, st, [{"real": _torch(b)} for b in case["batches"]]


@pytest.mark.parametrize("kind,workers", [("sim", 1), ("sim", 4),
                                          ("two_phase", 4)])
def test_device_phases_of_a_captured_window(kind, workers):
    """Spans on, a window of 4 steps: the capture covers steps 2..4, and
    every phase of the step has aten operators and allocations."""
    tr, st, batches = _trainer(True, kind, workers)
    p = StepProfiler(window=4, device_phases=True)
    for i, b in enumerate(batches):
        with p.phase("step"):
            st = tr.step(st, b).state
        p.record_step(i, 1e-3)
    s = p.summary()
    assert s["device_phase_steps"] == 3
    dev = s["device_phases"]
    assert list(dev) == [k for k in DEVICE_PHASES if k in dev]
    for phase in ("field", "compress", "exchange", "apply"):
        assert dev[phase]["ops"] > 0 and dev[phase]["bytes"] > 0, (phase,
                                                                   dev)
    assert None not in dev and s["device_unattributed"]["ops"] > 0


def test_phase_costs_without_spans_and_the_cuda_guard():
    """No ranges: every operator is outside every phase (the key None). A
    capture that claims a CUDA device but holds no kernel is refused, not
    reported."""
    from torch.profiler import ProfilerActivity, profile
    tr, st, batches = _trainer(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(st, batches[0])
    costs = phase_costs(prof, cuda=False)
    assert list(costs) == [None] and costs[None]["ops"] > 0
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        phase_costs(prof, cuda=True)


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    """The FunctionEvent fields `phase_costs` reads: a host event (an
    operator, a range or a launch call) or, with `cuda`, a kernel."""

    def __init__(self, name, start, end=None, parent=None, id=0, mem=0,
                 cuda=False):
        self.name, self.cpu_parent, self.id = name, parent, id
        self.time_range = _Range(start, start + 1 if end is None else end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.self_device_memory_usage = mem


class _Capture:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_phase_costs_charges_kernels_through_their_launch_calls():
    """A kernel is charged to the phase of the host call that launched it:
    through the call's operator and ranges on its own thread; on CUDA
    autograd runs the backward on its own thread, outside the step
    thread's ranges, so such a launch takes the phase of the innermost
    range open at its start; a launch outside every range is counted
    under None; a device event that no launch call made (a copy, a
    fill, a synchronization) is no kernel."""
    field = _Event(PREFIX + "field", 0, 90)
    exch = _Event(PREFIX + "exchange", 100, 200)
    comp = _Event(PREFIX + "compress", 120, 150, exch)
    mm = _Event("aten::mm", 10, 20, field, mem=64)
    bwd = _Event("aten::mm", 30, 40, mem=32)          # the autograd thread
    add = _Event("aten::add", 160, 170, exch)
    norm = _Event("aten::norm", 95, 99, mem=8)        # outside every range
    launch = lambda i, t, parent: _Event("cudaLaunchKernel", t, parent=parent,
                                         id=i)
    events = [field, exch, comp, mm, bwd, add, norm,
              launch(1, 11, mm), launch(2, 12, mm),       # field
              launch(3, 31, bwd),                         # field by time
              _Event("cuLaunchKernel", 130, parent=comp, id=4),   # compress
              launch(5, 135, None),                       # compress by time
              launch(6, 161, add),                        # exchange
              launch(7, 96, norm),                        # outside
              _Event("cudaMemsetAsync", 12, parent=mm, id=8)]
    events += [_Event("kernel", 300 + i, id=i, cuda=True)
               for i in (1, 2, 3, 4, 5, 6, 7)]
    events += [_Event("Memset (Device)", 400, id=8, cuda=True),
               _Event("Context Sync", 410, id=9, cuda=True)]
    costs = phase_costs(_Capture(events), cuda=True)
    assert list(costs) == ["compress", "exchange", "field", None]
    assert costs == {"compress": {"ops": 2, "bytes": 0},
                     "exchange": {"ops": 1, "bytes": 0},
                     "field": {"ops": 3, "bytes": 96},
                     None: {"ops": 1, "bytes": 8}}


def test_trace_dir_keeps_a_chrome_trace(tmp_path):
    tr, st, batches = _trainer(True)
    p = make_profiler(True, window=3, trace_dir=str(tmp_path / "tr"))
    for i, b in enumerate(batches[:3]):
        st = tr.step(st, b).state
        p.record_step(i, 1e-3)
    assert p.done
    (f,) = os.listdir(tmp_path / "tr")
    assert f == "repro_obs_steps_1_2.json"
    with open(tmp_path / "tr" / f) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert PREFIX + "exchange" in names
    assert p.summary()["trace_dir"] == str(tmp_path / "tr")


def test_cli_profile_window_renders_in_the_jax_report(tmp_path):
    """The training CLI with metrics, spans and a 3-step window writes a
    sink whose ``profile`` section ``python -m repro.obs report``
    renders, with operators per device phase."""
    path = str(tmp_path / "r.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dcgan32", "--smoke", "--device", "cpu", "--steps", "4",
         "--compressor", "qsgd8_block1024", "--comm-plan", "uniform",
         "--obs-metrics", "full", "--obs-spans", "--profile-steps", "3",
         "--obs-sink", path], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = subprocess.run([sys.executable, "-m", "repro.obs", "report", path],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert rep.returncode == 0, rep.stderr[-3000:]
    assert "profile window: steps 0...2" in rep.stdout
    for phase in ("field", "compress", "exchange", "apply"):
        assert f"device{phase:>9}:" in rep.stdout, rep.stdout
    assert "empirical δ̂ vs assumed δ" in rep.stdout
