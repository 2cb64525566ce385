"""`repro_torch.obs.tracing.PhaseClock` on the CPU: its arithmetic on
synthetic timestamps (self time, the union of a step's top-level spans,
the gaps between them with the host's time, the anchor), the spans of a
`DQGAN.step` under a clock (names, parents, one step index), the state and
metrics bit-equal with spans and clock on or off, the wait on a
collective in flight, and the step profiler's ``phase_ms``. The card's
device times are checked in `tests/test_torch_cuda.py`."""
from contextlib import nullcontext
from types import SimpleNamespace

import pytest
import torch

from repro_torch import checkpoint as CK
from repro_torch.core import exchange as X
from repro_torch.obs import tracing
from repro_torch.obs.profile import StepProfiler
from repro_torch.obs.tracing import (CLOCK_PHASES, DEVICE_PHASES, PhaseClock,
                                     Span, device_span, host_span, resolve)
from torch_ranks import one_thread  # noqa: F401 (autouse)


def S(name, parent, step, d_in, d_out, h_in, h_out):
    return Span(name, parent, step, d_in, d_out, h_in, h_out)


def test_resolve_self_time_union_and_gaps():
    """Two steps; step 0: field [0, 10] with nothing inside, exchange
    [12, 20] holding pack [12, 13] and compress [13, 18], apply [19, 22]
    overlapping the exchange; step 1: field [30, 35]. The host waits
    between field's exit (host 4) and exchange's entry (host 11)."""
    spans = [S("field", None, 0, 0.0, 10.0, 0.0, 4.0),
             S("exchange", None, 0, 12.0, 20.0, 11.0, 15.0),
             S("pack", 1, 0, 12.0, 13.0, 11.5, 12.0),
             S("compress", 1, 0, 13.0, 18.0, 12.0, 13.0),
             S("apply", None, 0, 19.0, 22.0, 15.0, 16.0),
             S("field", None, 1, 30.0, 35.0, 25.0, 26.0)]
    r = resolve(spans, n_steps=2, wall_ms=50.0)
    assert r.phases["field"] == {"count": 2, "device_ms": 15.0,
                                 "device_self_ms": 15.0, "host_ms": 5.0}
    ex = r.phases["exchange"]
    assert (ex["device_ms"], ex["device_self_ms"], ex["host_ms"]) == (
        8.0, 2.0, 4.0)
    assert r.phases["pack"]["device_self_ms"] == 1.0
    # step 0: the union of [0,10] [12,20] [19,22] is 20 ms, one gap of 2
    assert r.steps[0]["busy_ms"] == 20.0
    assert r.steps[0]["gaps"] == [{"after": "field", "before": "exchange",
                                   "device_ms": 2.0, "host_ms": 7.0}]
    assert r.steps[1] == {"step": 1, "busy_ms": 5.0, "gaps": []}
    assert r.per_step("field") == 7.5
    assert r.per_step("exchange", "device_self_ms") == 1.0
    assert r.per_step("wait") is None
    assert r.busy_ms_per_step() == 12.5
    assert r.host_gap_ms() == 25.0 - 12.5
    assert r.host_gap_ms(wall_ms=40.0, n_steps=2) == 20.0 - 12.5
    summ = r.summary()
    assert summ["exchange"] == {"count": 1, "device_ms": 4.0,
                                "device_self_ms": 1.0, "host_ms": 2.0}


def test_resolve_sees_through_host_phases_and_clips_children():
    """The launcher's ``step`` host span holds the step's device spans:
    they are the step's top level. A child that outlasts its parent (a
    side stream's work) takes off the self time only inside the parent."""
    spans = [S("data", None, 0, 0.0, 1.0, 0.0, 1.0),
             S("step", None, 0, 1.0, 30.0, 1.0, 30.0),
             S("field", 1, 0, 2.0, 10.0, 2.0, 3.0),
             S("exchange", 1, 0, 14.0, 20.0, 6.0, 7.0),
             S("compress", 3, 0, 16.0, 25.0, 6.5, 7.0)]
    r = resolve(spans, n_steps=1, wall_ms=40.0)
    assert r.steps[0]["busy_ms"] == 8.0 + 6.0
    assert r.steps[0]["gaps"] == [{"after": "field", "before": "exchange",
                                   "device_ms": 4.0, "host_ms": 3.0}]
    assert r.phases["exchange"]["device_self_ms"] == 2.0
    assert r.phases["step"]["device_self_ms"] == 29.0 - 14.0


def test_resolve_host_times_only():
    r = resolve([S("field", None, 0, None, None, 0.0, 2.0)], 1, 3.0)
    assert r.phases["field"] == {"count": 1, "device_ms": None,
                                 "device_self_ms": None, "host_ms": 2.0}
    assert r.steps == [{"step": 0, "busy_ms": None, "gaps": []}]
    assert r.per_step("field") is None and r.host_gap_ms() is None
    assert r.per_step("field", "host_ms") == 2.0


def _fields(s):
    return (s.name, s.parent, s.step, s.device_in, s.device_out, s.host_in,
            s.host_out)


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


class _FakeDeviceClock(PhaseClock):
    """A clock whose events are stamped from a list of device times."""

    def __init__(self, device_times):
        super().__init__("cpu")
        self._times = iter(device_times)

    def _event(self):
        return _FakeEvent(next(self._times))


def test_clock_times_are_taken_from_its_anchor(monkeypatch):
    """Device times are each event's elapsed time from the anchor event,
    host times perf_counter's from the anchor's; spans nest by the stack
    and take the step the caller is in."""
    host = iter([100.0, 100.001, 100.002, 100.004, 100.006, 100.020])
    monkeypatch.setattr(tracing, "time",
                        SimpleNamespace(perf_counter=lambda: next(host)))
    clock = _FakeDeviceClock([5.0, 6.0, 7.5, 9.0, 12.0])
    clock.start()                             # anchor: device 5, host 100
    try:
        with device_span("exchange"):         # device 6, host 1 ms
            with device_span("pack"):         # 7.5 / 2 ms .. 9 / 4 ms
                pass
        # the exchange exits at device 12, host 6 ms
        clock.end_step()
        with device_span("field", False):     # off: not timed
            pass
    finally:
        r = clock.stop()                      # host 100.020: 20 ms
    want = [S("exchange", None, 0, 1.0, 7.0, 1.0, 6.0),
            S("pack", 0, 0, 2.5, 4.0, 2.0, 4.0)]
    assert [s[:3] for s in map(_fields, r.spans)] == [
        s[:3] for s in map(_fields, want)]
    for got, exp in zip(r.spans, want):
        assert _fields(got)[3:] == pytest.approx(_fields(exp)[3:])
    assert r.n_steps == 1 and r.wall_ms == pytest.approx(20.0)
    assert not clock.active and tracing._ACTIVE is None


def test_clock_refuses_a_second_clock_and_a_stop_inside_a_span():
    a, b = PhaseClock(), PhaseClock()
    a.start()
    try:
        with pytest.raises(RuntimeError, match="already active"):
            b.start()
        with pytest.raises(RuntimeError, match="not active"):
            b.stop()
        span = device_span("field")
        span.__enter__()
        with pytest.raises(RuntimeError, match="inside span 'field'"):
            a.stop()
        span.__exit__(None, None, None)
    finally:
        tracing._ACTIVE = None
    assert isinstance(device_span("field", False), nullcontext)
    assert isinstance(host_span("data", False), nullcontext)
    assert not set(CLOCK_PHASES) & set(DEVICE_PHASES)


# --------------------------------------------------------------------------- #
# the step's spans
# --------------------------------------------------------------------------- #
MIX = dict(name="mix", image_size=0, data_dim=2, latent_dim=16, hidden=128)


def _strategy(kind):
    from repro_torch.strategy import Compression, ExchangePlan, Strategy
    from torch_ranks import fsdp_strategy
    if kind == "fsdp":
        return fsdp_strategy(), 4
    return Strategy(compression=Compression(
        compressor="qsgd8_block1024", plan="uniform", bucket_mb=0.03),
        exchange=ExchangePlan(kind="sim", worker_axes=())), 1


def _run(kind, spans, clock=None, steps=3):
    """(named final state, per-step metrics) of the mixture GAN."""
    from repro_torch.configs.base import DQConfig
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    strat, W = _strategy(kind)
    strat = strat.evolve(obs_spans=spans, obs_metrics="full")
    cfg = gan.GANConfig(**MIX)
    gen = torch.Generator().manual_seed(0)
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=1e-2), device="cpu", workers=W)
    st = tr.init(gan.init(cfg, generator=gen))
    mets = []
    if clock is not None:
        clock.start()
    try:
        for _ in range(steps):
            out = tr.step(st, {"real": torch.randn((64, 2), generator=gen)})
            st = out.state
            mets.append(out.metrics)
            if clock is not None:
                clock.end_step()
    finally:
        reading = clock.stop() if clock is not None else None
    return dict(CK._paths(st)), mets, reading


def _tree(reading, step):
    """{(parent name, name)} of one step's spans."""
    spans = reading.spans
    return {(None if s.parent is None else spans[s.parent].name, s.name)
            for s in spans if s.step == step}


@pytest.mark.parametrize("kind", ["packed", "per_bucket", "fsdp"])
def test_the_steps_spans_under_a_clock(kind, monkeypatch):
    """Spans on, a clock over 2 steps: each step records the lookahead,
    the field, the message, the exchange holding the packing, the
    compression and the unpacking, the apply and the carry, at the top
    level in that order, each span with its own step's index (fsdp: the
    unpacking follows the all-gather, in the apply)."""
    if kind == "per_bucket":
        from repro_torch.core.dqgan import DQGAN
        monkeypatch.setattr(DQGAN, "_packed_levels", lambda self, *a: None)
    _, _, r = _run("fsdp" if kind == "fsdp" else "sim", True, PhaseClock(),
                   steps=2)
    assert r.n_steps == 2 and {s.step for s in r.spans} == {0, 1}
    for step in (0, 1):
        top = [s.name for s in r.spans if s.step == step and s.parent is None]
        assert top == ["lookahead", "field", "message", "exchange", "apply",
                       "carry"]
        tree = _tree(r, step)
        assert {("exchange", "pack"), ("exchange", "compress")} <= tree
        assert ("apply" if kind == "fsdp" else "exchange", "unpack") in tree
        assert {p for p, _ in tree} <= {None, "exchange", "apply"}
    assert r.phases["compress"]["count"] >= 2
    assert all(rec["device_ms"] is None for rec in r.phases.values())
    assert all(s.host_out >= s.host_in >= 0 for s in r.spans)
    assert r.per_step("field", "host_ms") > 0


@pytest.mark.parametrize("kind", ["sim", "fsdp"])
def test_spans_and_clock_leave_the_step_bit_equal(kind):
    off, off_m, _ = _run(kind, False)
    on, on_m, r = _run(kind, True, PhaseClock())
    assert r.n_steps == 3 and r.phases
    assert list(off) == list(on)
    for k, v in off.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(on[k], v), k
        else:
            assert on[k] == v, k
    for a, b in zip(off_m, on_m):
        assert list(a) == list(b)
        for k in ("loss", "grad_norm", "error_norm"):
            assert torch.equal(a[k], b[k]), k
        for k, v in a["obs"].items():
            assert torch.equal(b["obs"][k], v), k


# --------------------------------------------------------------------------- #
# the wait on a collective in flight
# --------------------------------------------------------------------------- #
class _Work:
    def __init__(self):
        self.waited = 0

    def wait(self):
        self.waited += 1


class _FakeGroupWorkers(X.ProcessGroupWorkers):
    """`ProcessGroupWorkers` whose collectives are handed a fake work."""

    def __init__(self):
        # W = 4 workers, 2 on each of 2 ranks
        self.n, self.n_local, self.offset, self._divisor = 4, 2, 0, {}
        self.mesh = SimpleNamespace(n_exchange=2)
        self.works = []

    def _collective(self, kind, result, fn, *args, **kwargs):
        self.works.append(_Work())
        return self.works[-1]


def test_pending_wait_records_a_wait_span():
    """`_Pending.wait` opens ``repro.obs/wait`` around the work's wait, with
    the flag its starter passed, and only while the work is pending."""
    clock = PhaseClock().start()
    try:
        work = _Work()
        h = X._Pending(work, torch.ones(2), spans=True)
        assert torch.equal(h.wait(), torch.ones(2))
        h.wait()                               # done: no second span
        X._Pending(_Work(), torch.ones(2)).wait()            # spans off
        X._Pending(None, torch.ones(2), spans=True).wait()   # nothing pending
        wk = _FakeGroupWorkers()
        x = torch.ones((2, 4))
        for start in (wk.start_mean, wk.start_all_gather,
                      wk.start_reduce_scatter):
            start(x, spans=True).wait()
        start(x).wait()
        wk.start_all_to_all(torch.ones((2, 4, 3)), spans=True).wait()
    finally:
        r = clock.stop()
    assert work.waited == 1
    assert all(w.waited == 1 for w in wk.works)
    assert [s.name for s in r.spans] == ["wait"] * 5


# --------------------------------------------------------------------------- #
# the step profiler
# --------------------------------------------------------------------------- #
def test_profiler_window_carries_the_clocks_readings(capsys):
    """Spans on, a 4-step window: the clock times steps 2..4, as the
    capture does; the event's ``phase_ms`` has every span of the step with
    host milliseconds a step (device entries null on the CPU), and the
    report prints it."""
    from repro_torch.configs.base import DQConfig
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    from repro_torch.obs import report
    strat, W = _strategy("sim")
    cfg = gan.GANConfig(**MIX)
    gen = torch.Generator().manual_seed(0)
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=DQConfig.from_strategy(
        strat.evolve(obs_spans=True), optimizer="omd", lr=1e-2),
        device="cpu", workers=W)
    st = tr.init(gan.init(cfg, generator=gen))
    p = StepProfiler(window=4, device_phases=True)
    for i in range(4):
        with host_span("step"):
            st = tr.step(st, {"real": torch.randn((64, 2),
                                                  generator=gen)}).state
        p.record_step(i, 1e-3)
    s = p.summary()
    assert s["phase_steps"] == 3 and s["host_gap_ms"] is None
    ph = s["phase_ms"]
    assert {"step", "lookahead", "field", "message", "exchange", "pack",
            "compress", "unpack", "apply", "carry"} == set(ph)
    assert ph["field"]["count"] == 3 and ph["field"]["host_ms"] > 0
    assert ph["field"]["device_ms"] is None
    assert tracing._ACTIVE is None
    text = report.render({"profile": dict(s, step_s=s["step_s"])})
    assert "clock (ms a step over 3 steps)" in text
    assert "clock     field:        -         -" in text
    assert set(s["kernel_launches"].values()) == {0}    # the CPU: none
    assert "kernel launches over the 3 clocked steps: none" in text
    off = StepProfiler(window=2)
    off.record_step(0, 1e-3)
    off.record_step(1, 1e-3)
    assert "phase_ms" not in off.summary()
    assert "kernel_launches" not in off.summary()


def test_profiler_window_counts_the_kernels_launches(monkeypatch):
    """Spans on: the event's ``kernel_launches`` holds each kernel's
    launches in the clocked steps (past the window's first), and the
    report prints those that ran."""
    from repro_torch.kernels import ssd as SSD
    from repro_torch.obs import report
    monkeypatch.setattr(SSD, "ssd_launches", SSD.ssd_launches)
    monkeypatch.setattr(SSD, "ssd_bwd_launches", SSD.ssd_bwd_launches)
    p = StepProfiler(window=3, device_phases=True)
    for i in range(3):
        with host_span("step"):
            SSD.ssd_launches += 2     # a step's B5 calls, as on the card
            SSD.ssd_bwd_launches += 1
        p.record_step(i, 1e-3)
    s = p.summary()
    assert s["kernel_launches"]["ssd_chunked"] == 4
    assert s["kernel_launches"]["ssd_chunked_bwd"] == 2
    assert s["kernel_launches"]["quantize_ef"] == 0
    text = report.render({"profile": dict(s, step_s=s["step_s"])})
    assert ("kernel launches over the 2 clocked steps: ssd_chunked 4, "
            "ssd_chunked_bwd 2") in text
