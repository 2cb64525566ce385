"""The phase clock's readers on a synthetic run: a reading of two window
steps beside a capture of two steps, and None where the run has no clock
(a `--trace 0` run, or a program without the clock)."""
from types import SimpleNamespace

import pytest

from bench import trace
from bench.metrics import (carry_ms, field_wait_ms, host_gap_ms,
                           lookahead_ms, message_ms, pack_ms)
from repro_torch.obs.tracing import Span, resolve

READERS = (lookahead_ms, message_ms, carry_ms, pack_ms, field_wait_ms,
           host_gap_ms)


def reading():
    """Two steps (ms): lookahead 1, field 10 (the device idle 2 of them),
    message 1, exchange 4 holding pack 1 and unpack 0.5, apply 1, carry
    0.5; 1 ms between the field and the message on the device."""
    spans = []
    for step in (0, 1):
        t = 30.0 * step
        spans += [Span("lookahead", None, step, t, t + 1, t, t + 1),
                  Span("field", None, step, t + 1, t + 11, t + 1, t + 5),
                  Span("message", None, step, t + 12, t + 13, t + 11,
                       t + 12)]
        ex = len(spans)
        spans += [Span("exchange", None, step, t + 13, t + 17, t + 12,
                       t + 14),
                  Span("pack", ex, step, t + 13, t + 14, t + 12, t + 12.5),
                  Span("unpack", ex, step, t + 16.5, t + 17, t + 13.5,
                       t + 14),
                  Span("apply", None, step, t + 17, t + 18, t + 14, t + 15),
                  Span("carry", None, step, t + 18, t + 18.5, t + 15,
                       t + 16)]
    return resolve(spans, n_steps=2, wall_ms=60.0)


def ctx(clock):
    # the capture: 2 steps, 16 ms of field work (8 a step)
    cap = trace.Capture(device=[("k", 0.0, 16e3, "field", "aten::mm")])
    return SimpleNamespace(cap=cap, profile_steps=2, clock=clock,
                           window={"steps": 2, "seconds": 0.05})


def test_readers_on_a_synthetic_reading():
    c = ctx(reading())
    assert lookahead_ms.read(c) == 1.0
    assert message_ms.read(c) == 1.0
    assert carry_ms.read(c) == 0.5
    assert pack_ms.read(c) == 1.5
    assert field_wait_ms.read(c) == 10.0 - 8.0
    # 25 ms a step of wall against 17.5 under the step's phases
    assert host_gap_ms.read(c) == pytest.approx(25.0 - 17.5)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_none_without_a_clock(reader):
    assert reader.read(ctx(None)) is None
    c = ctx(None)
    del c.clock
    assert reader.read(c) is None


def test_none_where_the_program_has_no_such_span():
    r = resolve([Span("field", None, 0, 0.0, 5.0, 0.0, 1.0)], 1, 10.0)
    c = ctx(r)
    for reader in (lookahead_ms, message_ms, carry_ms, pack_ms):
        assert reader.read(c) is None
    assert field_wait_ms.read(c) == 5.0 - 16.0 / 2
