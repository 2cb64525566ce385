"""Phase attribution, device seconds and the idle share on a small
synthetic profiler trace (times in microseconds)."""
from types import SimpleNamespace

import pytest

from bench import trace
from bench.metrics import device_idle_share, exchange_alloc_gib, exchange_ms
from bench.metrics import field_ms, unspanned_ms


def ev(name, start, end, id=0, parent=None, thread=1, device=False,
       mem=0, linked=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end), id=id, cpu_parent=parent, thread=thread,
        device=device, self_device_memory_usage=mem,
        linked_correlation_id=linked)


def capture():
    field = ev("repro.obs/field", 0, 100)
    exch = ev("repro.obs/exchange", 100, 150)
    comp = ev("repro.obs/compress", 110, 140, parent=exch)
    op = ev("aten::mul", 5, 15, id=50, parent=field, mem=1 << 30)
    events = [
        field, exch, comp, op,
        ev("cudaLaunchKernel", 10, 12, id=1, parent=op),
        ev("mul_kernel", 20, 50, id=1, device=True),
        # the backward's thread: no range around it, the field by time
        ev("cudaLaunchKernel", 60, 61, id=2, thread=2),
        ev("bwd_kernel", 60, 70, id=2, device=True),
        ev("cudaLaunchKernel", 115, 116, id=3, parent=comp),
        ev("quantize_ef_row1024", 120, 130, id=3, device=True),
        ev("aten::cat", 101, 105, id=60, parent=exch, mem=1 << 29),
        ev("cudaMemcpyAsync", 102, 103, id=4, parent=exch),
        ev("Memcpy DtoD", 140, 146, id=4, device=True),
        # outside every range
        ev("cudaLaunchKernel", 160, 161, id=5),
        ev("norm_kernel", 170, 180, id=5, device=True),
        # a kernel whose launch the capture lacks, found by its op
        ev("aten::add", 185, 186, id=70),
        ev("add_kernel", 190, 195, id=99, device=True, linked=70),
        # a host range mirrored on the device's timeline: not device work
        ev("repro.obs/field", 0, 100, id=7, device=True),
    ]
    return trace.from_events(events, lambda e: e.device)


def test_phase_seconds():
    cap = capture()
    got = trace.phase_seconds(cap)
    assert abs(got["field"] - 40e-6) < 1e-12
    assert abs(got["compress"] - 10e-6) < 1e-12
    assert abs(got["exchange"] - 6e-6) < 1e-12
    assert abs(got[None] - 15e-6) < 1e-12
    assert cap.unmatched == 0
    assert cap.alloc == {"field": 1 << 30, "exchange": 1 << 29}


def test_busy_idle_and_readers():
    cap = capture()
    # union: [20,50] [60,70] [120,130] [140,146] [170,180] [190,195]
    assert abs(trace.busy_seconds(cap) - 71e-6) < 1e-12
    # the window: 4 steps in 400 us, so 100 us a step, 35.5 of them busy
    ctx = SimpleNamespace(cap=cap, profile_steps=2, alloc=cap.alloc,
                          window={"steps": 4, "seconds": 400e-6})
    assert abs(device_idle_share.read(ctx) - 100 * (1 - 35.5 / 100)) < 1e-9
    assert abs(field_ms.read(ctx) - 40e-6 / 2 * 1e3) < 1e-12
    assert abs(exchange_ms.read(ctx) - 16e-6 / 2 * 1e3) < 1e-12
    assert abs(unspanned_ms.read(ctx) - 15e-6 / 2 * 1e3) < 1e-12
    assert exchange_alloc_gib.read(ctx) == 0.5


def test_breakdown():
    cap = capture()
    ops = trace.top_device_ops(cap, 2)
    assert [o[0] for o in ops] == ["mul_kernel", "bwd_kernel"]
    gaps = trace.idle_gaps(cap, 2)
    # the longest gap, 70..120, ends in the compress phase's B1 launch
    assert gaps[0][0] == "repro.obs/compress in compress"
    assert abs(gaps[0][1] - 50e-6) < 1e-12
    # the next, 146..170, ends in a launch outside every phase
    assert gaps[1][0] == "cudaLaunchKernel in -"
    assert abs(gaps[1][1] - 24e-6) < 1e-12
    assert trace.kernel_seconds(cap, "quantize_ef") == pytest.approx([10e-6])
