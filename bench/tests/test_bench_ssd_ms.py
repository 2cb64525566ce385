"""`ssd_ms` against a capture worked by hand."""
from types import SimpleNamespace

from bench import trace
from bench.metrics import ssd_ms


def test_ssd_ms_sums_the_ssd_kernels_a_step():
    cap = trace.Capture(device=[
        ("void (anonymous namespace)::ssd_chunk_scan<__nv_bfloat16>(Ops, "
         "__nv_bfloat16*)", 0.0, 3000.0, "field", "aten::mm"),
        ("void (anonymous namespace)::ssd_chunk_bwd_dg<__nv_bfloat16>(Ops, "
         "float*, float*, float*, float*)", 5000.0, 6500.0, "field", ""),
        ("void at::native::elementwise_kernel<128, 2>", 7000.0, 9000.0,
         "field", "aten::mul")])
    ctx = SimpleNamespace(cap=cap, profile_steps=2)
    # (3.0 + 1.5) ms of the set's kernels over 2 steps; the rest left out
    assert abs(ssd_ms.read(ctx) - 2.25) < 1e-12
    # a capture without the set (the plain SSD), and no capture at all
    ctx.cap = trace.Capture(device=cap.device[2:])
    assert ssd_ms.read(ctx) is None
    assert ssd_ms.read(SimpleNamespace(cap=None, profile_steps=2)) is None
