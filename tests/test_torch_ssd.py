"""B5's wrapper (`kernels.ssd`) on the CPU and the meta device: the plain
version runs (`kernels.ref.ssd_chunked_ref`, the mixers' chunked SSD),
nothing counts as a launch, the dry-run traces mamba2 through it, and the
checks refuse the operands the CUDA kernels do not take. The kernels
themselves are held against the plain version on the card by
`tests/test_torch_cuda.py -k ssd`; the plain version against the JAX
package by `tests/test_torch_mixers.py`."""
import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.kernels import _build
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels.ref import ssd_chunked_ref
from torch_ranks import one_thread  # noqa: F401 (autouse)

META = torch.device("meta")


def _operands(B, T, H, P, N, dtype=torch.float32, device=None, seed=0):
    """x, B and C as views of one (B, T, H·P + 2N) tensor, as the mixer
    splits its conv output; dt, A and D float32."""
    rs = np.random.RandomState(seed)
    di = H * P
    xbc = torch.from_numpy(rs.randn(B, T, di + 2 * N).astype(np.float32))
    xbc = xbc.to(dtype)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rs.randn(B, T, H).astype(np.float32)) - 1)
    A = -torch.exp(torch.from_numpy(rs.randn(H).astype(np.float32)))
    D = torch.from_numpy(rs.randn(H).astype(np.float32))
    ops = (xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:], dt, A, D)
    if device is not None:
        ops = tuple(torch.empty_like(t, device=device) for t in ops)
    return ops


def _refuse(*a, **k):
    raise AssertionError("the CUDA path ran")


@pytest.mark.parametrize("B,T,H,P,N,chunk,dtype", [
    (2, 64, 32, 16, 16, 32, torch.float32),   # the reduced mamba2
    (2, 35, 4, 16, 16, 7, torch.float32),     # T = 35 at chunk 7
    (1, 48, 3, 8, 4, 64, torch.bfloat16)])    # T < chunk; widths B5 lacks
def test_cpu_path_is_the_plain_version_and_counts_no_launch(
        B, T, H, P, N, chunk, dtype, monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse)
    x, Bm, Cm, dt, A, D = _operands(B, T, H, P, N, dtype)
    SSD.reset_launches()
    y, h = SSD.ssd_chunked(x, Bm, Cm, dt, A, D, P, chunk)
    y_ref, h_ref = ssd_chunked_ref(x, Bm, Cm, dt, A, D, P, chunk)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert y.dtype == dtype and h.dtype == torch.float32
    # and its backward is the plain version's autograd
    leaves = [t.detach().float().requires_grad_() for t in (x, Bm, Cm, dt,
                                                           A, D)]
    y, h = SSD.ssd_chunked(*leaves, P, chunk)
    (y.square().sum() + h.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
    assert (SSD.ssd_launches, SSD.ssd_bwd_launches) == (0, 0)


def test_meta_operands_trace_the_abstract_form(monkeypatch):
    """Meta operands at mamba2-1.3b's widths (P 64, N 128, chunk 256) take
    the kernels' path to its abstract form: the outputs' shapes and dtypes,
    the tensors the forward saves (cum, the chunk decays, the states
    entering each chunk) and the backward's gradients, with no launch and
    none of the plain version's work; the meta calls are counted apart."""
    monkeypatch.setattr(_build, "load", _refuse)
    monkeypatch.setattr(SSD, "ssd_chunked_ref", _refuse)
    SSD.reset_launches()
    x, Bm, Cm, dt, A, D = _operands(2, 512, 64, 64, 128, torch.bfloat16,
                                    device=META)
    leaves = [t.requires_grad_() for t in (x, Bm, Cm, dt, A, D)]
    y, h = SSD.ssd_chunked(*leaves, 64, 256)
    assert (y.device.type, tuple(y.shape), y.dtype) == (
        "meta", (2, 512, 4096), torch.bfloat16)
    assert (tuple(h.shape), h.dtype) == ((2, 64, 64, 128), torch.float32)
    saved = y.grad_fn.next_functions[0][0].next_functions[0][0]
    grads = torch.autograd.grad((y, h), leaves, (torch.empty_like(y),
                                                 torch.empty_like(h)))
    assert [(tuple(g.shape), g.dtype) for g in grads] == [
        (tuple(t.shape), t.dtype) for t in leaves]
    assert saved is not None
    assert (SSD.ssd_launches, SSD.ssd_bwd_launches) == (0, 0)
    assert (SSD.ssd_meta_launches, SSD.ssd_bwd_meta_launches) == (1, 1)


def test_meta_trace_holds_no_chunk_blocks():
    """The abstract form's allocations at a mamba2 layer's prefill: at most
    what the card allocates (y, the final state, cum, the chunk decays,
    the states, and the skip's two bfloat16 temporaries), far below one of
    the plain version's (B, nc, L, L, H) float32 blocks."""
    from repro_torch.launch import op_analysis as OA
    B, T, H, P, N, L = 2, 2048, 64, 64, 128, 256
    x, Bm, Cm, dt, A, D = _operands(B, T, H, P, N, torch.bfloat16,
                                    device=META)
    res = OA.analyze(SSD.ssd_chunked, x, Bm, Cm, dt, A, D, P, L)
    nc = T // L
    block = B * nc * L * L * H * 4
    made = res["peak_bytes"] - res["held_bytes"]
    card = (2 * B * T * H * P * 2 + 4 * (B * H * P * N + B * T * H
                                         + B * nc * H + B * nc * H * P * N))
    assert B * T * H * P * 2 <= made <= card + 2 * B * T * H * P * 2
    assert made < block / 2


def test_dryrun_traces_mamba2_through_the_abstract_form(monkeypatch):
    """`launch.dryrun` on mamba2 (reduced widths, a training step at model
    16): every SSD call of the traced step takes B5's abstract form,
    forward twice a layer (the field's and remat's) and backward once,
    and none the plain version or the CUDA path; the record counts them
    as meta launches."""
    from repro_torch.launch import dryrun
    get = tcfgs.get
    monkeypatch.setattr(tcfgs, "get", lambda name: get(name).reduced())
    monkeypatch.setattr(_build, "load", _refuse)
    monkeypatch.setattr(SSD, "ssd_chunked_ref", _refuse)
    SSD.reset_launches()
    rec = dryrun.run_combo("mamba2-1.3b", "train_4k", False, exchange="sim",
                           layout="dp", quiet=True)
    assert rec["status"] == "ok", rec.get("error")
    layers = get("mamba2-1.3b").reduced().num_layers
    assert (SSD.ssd_meta_launches, SSD.ssd_bwd_meta_launches) == (
        2 * layers, layers)
    assert (SSD.ssd_launches, SSD.ssd_bwd_launches) == (0, 0)


REFUSALS = {
    # case: (B, T, H, P, N, chunk, x's dtype, edit of the operands, error)
    "P 8": (1, 64, 4, 8, 16, 32, torch.float32, None, ValueError),
    "P 256": (1, 64, 1, 256, 16, 32, torch.float32, None, ValueError),
    "N 8": (1, 64, 2, 16, 8, 32, torch.float32, None, ValueError),
    "N 256": (1, 64, 2, 16, 256, 32, torch.float32, None, ValueError),
    "chunk 512": (1, 512, 2, 16, 16, 512, torch.float32, None, ValueError),
    "float16": (1, 64, 2, 16, 16, 32, torch.float16, None, TypeError),
    "B in bfloat16": (1, 64, 2, 16, 16, 32, torch.float32,
                      lambda o: (o[0], o[1].bfloat16()) + o[2:], TypeError),
    "dt in bfloat16": (1, 64, 2, 16, 16, 32, torch.float32,
                       lambda o: o[:3] + (o[3].bfloat16(),) + o[4:],
                       TypeError),
    "C's channels strided": (1, 64, 2, 16, 16, 32, torch.float32,
                             lambda o: o[:2] + (o[2].transpose(1, 2)
                                                .contiguous()
                                                .transpose(1, 2),) + o[3:],
                             ValueError),
    "x off 16 bytes": (1, 64, 2, 16, 16, 32, torch.bfloat16,
                       lambda o: (torch.zeros(1, 64, 40, dtype=torch.bfloat16)
                                  [..., 1:33],) + o[1:], ValueError),
    "B's rows 36 bytes apart": (1, 64, 2, 16, 16, 32, torch.float32,
                                lambda o: (o[0], torch.zeros(1, 64, 25)
                                           [..., :16]) + o[2:], ValueError),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_kernel_check_refuses_what_the_kernels_do_not_take(case):
    """`kernel_check`, which every CUDA call runs before its launch, on CPU
    operands: it refuses these, and takes the shapes that the main path
    and the reduced config use."""
    B, T, H, P, N, chunk, dtype, edit, err = REFUSALS[case]
    ops = _operands(B, T, H, P, N, dtype)
    if edit is not None:
        ops = edit(ops)
    x, Bm, Cm, dt, A, _ = ops
    with pytest.raises(err):
        SSD.kernel_check(x, Bm, Cm, dt, A, P, min(chunk, T))


@pytest.mark.parametrize("B,T,H,P,N,chunk,dtype", [
    (2, 2048, 64, 64, 128, 256, torch.bfloat16),   # mamba2-1.3b's cell
    (2, 2048, 32, 64, 128, 256, torch.bfloat16),   # a rank of two
    (2, 64, 32, 16, 16, 32, torch.float32),        # the reduced config
    (2, 35, 4, 16, 16, 7, torch.float32),
    (1, 512, 3, 128, 32, 256, torch.float32)])
def test_kernel_check_takes_the_main_paths_shapes(B, T, H, P, N, chunk,
                                                  dtype):
    x, Bm, Cm, dt, A, _ = _operands(B, T, H, P, N, dtype, device=META)
    SSD.kernel_check(x, Bm, Cm, dt, A, P, min(chunk, T))


def test_t_not_a_multiple_of_the_chunk_is_refused_on_every_path():
    x, Bm, Cm, dt, A, D = _operands(1, 40, 2, 16, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SSD.ssd_chunked(x, Bm, Cm, dt, A, D, 16, 32)


# the kernels' source, read for its C entry points and its sums
SRC = (_build.CSRC / "ssd_chunked.cu").read_text()


def _c_params(head):
    """The number of parameters of the C function (or the function a
    macro defines) whose declaration starts with `head`."""
    sig = SRC[SRC.index(head) + len(head):]
    return sig[:sig.index(") {")].count(",") + 1


def _fake_library():
    import types
    return types.SimpleNamespace(**{
        f"ssd_chunked_{p}_{e}": types.SimpleNamespace()
        for p in ("fwd", "bwd") for e in ("bf16", "f32")})


@pytest.mark.parametrize("pass_,macro", [("fwd", "SSD_FWD"),
                                         ("bwd", "SSD_BWD")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_argtypes_match_the_sources_entry_points(monkeypatch, pass_,
                                                         macro, dtype):
    """Each pass and element type has its C entry point in the one
    library, and the wrapper declares as many arguments as it takes."""
    e = "bf16" if dtype == torch.bfloat16 else "f32"
    assert f"{macro}(ssd_chunked_{pass_}_{e}, " in SRC
    lib = _fake_library()
    monkeypatch.setattr(_build, "load", lambda name: (
        lib if name == "ssd_chunked" else _refuse()))
    monkeypatch.setattr(SSD, "_fns", {})
    fn = SSD._fn(pass_, dtype)
    assert fn is getattr(lib, f"ssd_chunked_{pass_}_{e}")
    assert len(fn.argtypes) == _c_params(f"#define {macro}(NAME, E)")


def test_workspace_size_follows_the_sources_layout():
    """`ws_floats`, the backward's scratch, part by part as the source's
    `Work` lays it, each part rounded up to 4 floats: at mamba2-1.3b's cell
    dcum and dlast (B·T·H each), 4 slots each of dcum and ddt, the d(cd)
    parts of 32 CTAs over P·N and 10 dG tiles for each of 4 head groups;
    at T = 35, chunk 7, 3 heads, 16 x 16 the odd counts round up."""
    bth = 2 * 2048 * 64
    assert SSD.ws_floats(2, 2048, 64, 64, 128, 256) == (
        2 * bth + 2 * 4 * bth + 2 * 8 * 64 * 32 + 2 * 8 * 10 * 4 * 64 * 64)
    assert SSD.ws_floats(1, 35, 3, 16, 16, 7) == (
        2 * 108 + 2 * 108 + 16 + 5 * 64 * 64)
    assert "if (ws_floats < Work(o).floats()) return -2;" in SRC


def test_kernels_add_by_no_atomic():
    """The backward's shared sums go through workspace slots summed in a
    fixed order, so a seeded run repeats bit for bit: no kernel of the
    source adds to memory by an atomic."""
    import re
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", SRC)
    assert "bwd_gbc" in SRC and "dcdp" in SRC


def test_launch_counts_read_each_wrappers_counter(monkeypatch):
    """`kernels.launch_counts` reads B1-B4's counters and B5's two; a
    CPU call of B5's wrapper adds to none of them."""
    from repro_torch import kernels
    from repro_torch.kernels import quantize as Q
    before = kernels.launch_counts()
    assert set(before) == {"quantize_ef", "quantize_ef_dyn",
                           "paged_attention", "flash_attention",
                           "ssd_chunked", "ssd_chunked_bwd"}
    x, Bm, Cm, dt, A, D = _operands(1, 64, 2, 16, 16)
    SSD.ssd_chunked(x, Bm, Cm, dt, A, D, 16, 32)
    assert set(kernels.launches_since(before).values()) == {0}
    monkeypatch.setattr(SSD, "ssd_launches", SSD.ssd_launches + 4)
    monkeypatch.setattr(SSD, "ssd_bwd_launches", SSD.ssd_bwd_launches + 2)
    monkeypatch.setattr(Q, "launches", Q.launches + 1)
    assert kernels.launches_since(before) == dict(
        dict.fromkeys(before, 0), ssd_chunked=4, ssd_chunked_bwd=2,
        quantize_ef=1)


def test_op_analysis_reports_the_calls_launches(monkeypatch):
    """`op_analysis.analyze` returns each kernel's launches during the
    call: none for a mamba2 layer on the CPU (the plain version), and
    what the wrappers count when they launch."""
    from repro_torch.launch import op_analysis as OA
    x, Bm, Cm, dt, A, D = _operands(1, 64, 2, 16, 16)
    res = OA.analyze(SSD.ssd_chunked, x, Bm, Cm, dt, A, D, 16, 32)
    assert res["launches"]["ssd_chunked"] == 0
    assert set(res["launches"].values()) == {0}

    def launching(*a):
        SSD.ssd_launches += 1        # what a call on CUDA tensors counts
        return ssd_chunked_ref(*a)
    monkeypatch.setattr(SSD, "ssd_launches", SSD.ssd_launches)
    res = OA.analyze(launching, x, Bm, Cm, dt, A, D, 16, 32)
    assert res["launches"]["ssd_chunked"] == 1
    assert res["launches"]["ssd_chunked_bwd"] == 0
