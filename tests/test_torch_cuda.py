"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain versions, and the trainer's and the serving engine's paths through
them. They import torch and
the port only (no jax), so they run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card each skips, deciding inside the test."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import quantize as Q
from repro_torch.kernels.ref import (flash_attention_ref, paged_attention_ref,
                                     quantize_ef_ref)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(seed, rows, cols, dev):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        0.3 * rs.randn(rows, cols), 0.05 * rs.randn(rows, cols),
        rs.rand(rows, cols)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,levels", [(648, 1024, 127),
                                              (512, 1024, 127),
                                              (37, 1024, 7), (64, 128, 1),
                                              (16, 12288, 127)])
def test_quantize_ef_kernel_matches_plain_version(rows, cols, levels):
    """Same arithmetic in the same order: scale bit-equal, codes equal but
    for rounding-boundary flips (at most 1e-5), e' bit-equal where the
    codes agree."""
    dev = _device()
    g, e, r = _operands(rows, rows, cols, dev)
    before = Q.launches
    ck, sk, ek = Q.quantize_ef_blocked(g, e, r, levels=levels,
                                       block_rows=rows)
    assert Q.launches == before + 1
    cp, sp, ep = quantize_ef_ref(g, e, r, levels)
    assert torch.equal(sk, sp)
    same = ck == cp
    assert (~same).float().mean().item() <= 1e-5
    assert torch.equal(ek[same], ep[same])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,levels", [(2592, 1024, 127),
                                              (2048, 1024, 7), (37, 1024, 1),
                                              (16, 12288, 7)])
def test_quantize_ef_dyn_kernel_matches_plain_version(rows, cols, levels):
    """B2 (levels read from device memory): the same checks as B1, and the
    same codes, scale and residual as B1 at the same level count."""
    dev = _device()
    g, e, r = _operands(rows + 1, rows, cols, dev)
    lv = torch.full((1,), float(levels), device=dev)
    before = (Q.launches, Q.launches_dyn)
    ck, sk, ek = Q.quantize_ef_blocked(g, e, r, levels=lv, block_rows=rows)
    assert (Q.launches, Q.launches_dyn) == (before[0], before[1] + 1)
    cp, sp, ep = quantize_ef_ref(g, e, r, lv)
    assert torch.equal(sk, sp)
    same = ck == cp
    assert (~same).float().mean().item() <= 1e-5
    assert torch.equal(ek[same], ep[same])
    cb, sb, eb = Q.quantize_ef_blocked(g, e, r, levels=levels,
                                       block_rows=rows)
    assert torch.equal(cb, ck) and torch.equal(sb, sk) and torch.equal(eb, ek)


@pytest.mark.cuda
def test_quantize_ef_kernel_refuses_what_it_does_not_take():
    dev = _device()
    g, e, r = _operands(0, 8, 1024, dev)
    with pytest.raises(TypeError):
        Q.quantize_ef_blocked(g.double(), e, r)
    with pytest.raises(ValueError):
        Q.quantize_ef_blocked(g, e.cpu(), r)
    with pytest.raises(ValueError):
        Q.quantize_ef_blocked(g, e, r.t().contiguous().t())
    with pytest.raises(ValueError, match="levels is on"):
        Q.quantize_ef_blocked(g, e, r, levels=torch.tensor([127.0]))
    with pytest.raises(ValueError, match="one element"):
        Q.quantize_ef_blocked(g, e, r,
                              levels=torch.full((2,), 7.0, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_rows", [(648, 648, 512), (13,),
                                         (648, 648, 512, 3)])
@pytest.mark.parametrize("levels", [127, 7, 1])
def test_quantize_ef_row1024_kernel_is_bit_equal(bucket_rows, levels):
    """B1 at 1024 columns (one warp a row), one launch over a step's
    buckets packed back to back, against the plain version: codes, scale
    and e' to the last bit, at the trainer's bucket rows and at row counts
    that do not fill a block's 8 rows."""
    dev = _device()
    R = sum(bucket_rows)
    g, e, r = _operands(R + levels, R, 1024, dev)
    g[0].zero_()
    e[0].zero_()
    g[R - 1, 17] = 3.0e20
    before = Q.launches
    ck, sk, ek = Q.quantize_ef_flat(g.reshape(-1), e.reshape(-1),
                                    r.reshape(-1), levels=levels)
    assert Q.launches == before + 1
    cp, sp, ep = quantize_ef_ref(g, e, r, levels)
    assert torch.equal(ck, cp.reshape(-1))
    assert torch.equal(sk, sp.reshape(-1))
    assert torch.equal(ek, ep.reshape(-1))


@pytest.mark.cuda
def test_quantize_ef_row1024_kernel_refuses_what_it_does_not_take():
    dev = _device()
    g, e, r = (x.reshape(-1) for x in _operands(0, 8, 1024, dev))
    with pytest.raises(TypeError):
        Q.quantize_ef_flat(g.double(), e, r)
    with pytest.raises(ValueError):
        Q.quantize_ef_flat(g, e.cpu(), r)
    with pytest.raises(ValueError):
        Q.quantize_ef_flat(g[1:1025], e[:1024], r[:1024])  # misaligned


@pytest.mark.cuda
def test_trainer_step_goes_through_the_kernel():
    """dcgan32 bucketed qsgd8_block1024: one B1 launch a step over all
    three buckets, packed back to back."""
    dev = _device()
    from repro_torch.configs import DQConfig, get
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.data import procedural_images
    from repro_torch.models import gan
    from repro_torch.strategy import Compression, Strategy

    cfg = get("dcgan32")
    strat = Strategy(compression=Compression(compressor="qsgd8_block1024",
                                             plan="uniform"))
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg),
               dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4),
               device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tr.init(gan.init(cfg, generator=gen, device=dev))
    before = Q.launches
    for _ in range(2):
        batch = {"real": procedural_images(8, 32, 3, generator=gen,
                                           device=dev)}
        out = tr.step(state, batch)
        state = out.state
    assert Q.launches == before + 2
    assert torch.isfinite(out.metrics["loss"]).item()


@pytest.mark.cuda
def test_four_worker_adaptive_step_goes_through_b2():
    """dcgan32, 4 stacked workers, half of them reporting, adaptive
    delta_budget: one B2 launch per bucket a step, no B1."""
    dev = _device()
    from repro_torch.configs import DQConfig, get
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.data import procedural_images
    from repro_torch.models import gan
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Strategy)

    cfg = get("dcgan32")
    strat = Strategy(
        compression=Compression(compressor="qsgd8_block1024",
                                plan="delta_budget", budget_mb=0.75,
                                adaptive=True),
        exchange=ExchangePlan(kind="sim", worker_axes=("data",)),
        participation=Participation(fraction=0.5))
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg),
               dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4),
               device=dev, workers=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tr.init(gan.init(cfg, generator=gen, device=dev))
    before = (Q.launches, Q.launches_dyn)
    for _ in range(2):
        batch = {"real": procedural_images(16, 32, 3, generator=gen,
                                           device=dev)}
        out = tr.step(state, batch)
        state = out.state
    assert (Q.launches, Q.launches_dyn) == (before[0], before[1] + 6)
    assert torch.isfinite(out.metrics["loss"]).item()


def _paged_operands(seed, B, Kh, G, D, bs, maxb, lengths, dtype, dev,
                    parked=()):
    """Random q and pools, ragged tables over distinct pool blocks; rows in
    `parked` point every entry at block 0 (the engine's scratch block)."""
    rs = np.random.RandomState(seed)
    nbs = [-(-L // bs) for L in lengths]
    NB = 1 + sum(nbs)
    perm = rs.permutation(np.arange(1, NB))
    table = np.zeros((B, maxb), np.int32)
    off = 0
    for b, nb in enumerate(nbs):
        if b not in parked:
            table[b, :nb] = perm[off:off + nb]
        off += nb
    t = [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)
         for shape in ((B, Kh, G, D), (NB, bs, Kh, D), (NB, bs, Kh, D))]
    return t + [torch.from_numpy(table).to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev)]


def _bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of max|x|."""
    m = float(x.abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


PAGED_CASES = [
    # the serving path's shapes: gemma-2b, 16 rows, contexts up to 319
    ("engine", 16, 1, 8, 256, 16, 20, [257 + 4 * i for i in range(15)]
     + [319]),
    ("edges", 6, 1, 8, 256, 16, 20, [0, 1, 16, 320, 33, 1]),
    ("jax test shape", 3, 2, 2, 16, 4, 5, [1, 7, 20]),
    ("D 64", 3, 1, 4, 64, 16, 4, [9, 64, 50]),
    ("D 128, wide blocks", 3, 2, 8, 128, 32, 4, [100, 128, 5]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_attention_kernel_matches_plain_version(case, dtype):
    """B3 against its plain version on the same tensors: float32 within
    2e-5 (the JAX test's), bfloat16 within one bf16 ulp of the output's
    magnitude (both compute in float32 and round once); L = 0 gives 0."""
    dev = _device()
    _, B, Kh, G, D, bs, maxb, lengths = case
    ops = _paged_operands(B + D, B, Kh, G, D, bs, maxb, lengths, dtype, dev,
                          parked=(5,) if B == 6 else ())
    before = FA.launches
    got = FA.paged_flash_attention(*ops)
    assert FA.launches == before + 1
    want = paged_attention_ref(*ops)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else _bf16_ulp(want.float())
    assert err <= tol, (err, tol)
    for b, L in enumerate(lengths):
        if L == 0:
            assert float(got[b].abs().max()) == 0.0


def _check_paged(ops, dtype, lengths):
    before = FA.launches
    got = FA.paged_flash_attention(*ops)
    assert FA.launches == before + 1
    want = paged_attention_ref(*ops)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else _bf16_ulp(want.float())
    assert err <= tol, (err, tol)
    for b, L in enumerate(lengths):
        if L == 0:
            assert float(got[b].abs().max()) == 0.0


# the split of a row's blocks over a cluster (8 CTAs a row at 16 rows, 20
# blocks a row): (label, B, MAXB, lengths, parked rows)
SPLIT_CASES = [
    ("share boundaries", 16, 20,
     [128, 256, 255, 129, 320, 0, 1, 48, 112, 144, 32, 69, 96, 16, 5, 192],
     (14,)),
    ("fewer blocks than CTAs", 16, 20, [1 + 7 * i for i in range(16)], ()),
    ("MAXB 13, not a multiple of the share", 16, 13,
     [208 - 13 * i for i in range(16)], (3,)),
    ("shares longer than a stage", 16, 64, [1024 - 61 * i for i in range(16)],
     ()),
    ("cluster of 1", 140, 4, [(5 * i) % 65 for i in range(140)], (7,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_paged_attention_kernel_split_edges(case, dtype):
    """B3's cluster split at its edges, gemma-2b's heads (K = 1, G = 8, D =
    256, bs = 16): the same tolerances as above."""
    dev = _device()
    _, B, maxb, lengths, parked = case
    ops = _paged_operands(B + maxb, B, 1, 8, 256, 16, maxb, lengths, dtype,
                          dev, parked=parked)
    _check_paged(ops, dtype, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
def test_paged_attention_kernel_every_head_dim(D, dtype):
    dev = _device()
    lengths = [0, 1, 64, 65, 33, 128]
    ops = _paged_operands(D, 6, 2, 4, D, 16, 8, lengths, dtype, dev,
                          parked=(5,))
    _check_paged(ops, dtype, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_table_past_256_entries(dtype):
    """A row table longer than the block's threads is read from device
    memory, not staged."""
    dev = _device()
    lengths = [1200, 577, 0]
    ops = _paged_operands(3, 3, 1, 2, 16, 4, 300, lengths, dtype, dev)
    _check_paged(ops, dtype, lengths)


@pytest.mark.cuda
def test_paged_attention_kernel_two_calls_with_different_batch():
    """Nothing carries over between calls: two batches in a row (clusters
    of 8, then of 1) each match their plain version."""
    dev = _device()
    for B in (16, 150, 16):
        lengths = [(37 * i) % 320 for i in range(B)]
        ops = _paged_operands(B, B, 1, 8, 256, 16, 20, lengths,
                              torch.bfloat16, dev)
        _check_paged(ops, torch.bfloat16, lengths)


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_what_it_does_not_take():
    dev = _device()
    q, pk, pv, table, lengths = _paged_operands(0, 3, 2, 2, 16, 4, 5,
                                                [1, 7, 20], torch.float32, dev)
    before = FA.launches
    with pytest.raises(TypeError, match="one dtype"):
        FA.paged_flash_attention(q, pk.bfloat16(), pv, table, lengths)
    with pytest.raises(TypeError, match="int32"):
        FA.paged_flash_attention(q, pk, pv, table.long(), lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.paged_flash_attention(q.half(), pk.half(), pv.half(), table,
                                 lengths)
    with pytest.raises(ValueError, match="contiguous"):
        FA.paged_flash_attention(q.transpose(1, 2).contiguous()
                                 .transpose(1, 2), pk, pv, table, lengths)
    with pytest.raises(ValueError, match="is on"):
        FA.paged_flash_attention(q, pk, pv, table.cpu(), lengths)
    with pytest.raises(ValueError, match="D in"):
        FA.paged_flash_attention(q[..., :8].contiguous(),
                                 pk[..., :8].contiguous(),
                                 pv[..., :8].contiguous(), table, lengths)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = pk.flatten()[2:2 + pv[1:].numel()].view(pv[1:].shape)
        FA.paged_flash_attention(q, shifted, pv[1:], table, lengths)
    with pytest.raises(ValueError, match="G <= 8"):
        FA.paged_flash_attention(torch.zeros(3, 1, 16, 16, device=dev),
                                 pk[:, :, :1].contiguous(),
                                 pv[:, :, :1].contiguous(), table, lengths)
    assert FA.launches == before


@pytest.mark.cuda
def test_attention_plans_read_the_kernels_tiles_and_shared_memory():
    """The CUDA sources own B4's tiles and B3's shared-memory layout and
    export them: the tiles are those the CPU plan tests assume
    (`KERNEL_TILES` of tests/test_torch_attention_split.py), the serving
    shape's stage fits one CTA in both types, and a block too large for
    one is refused before a launch."""
    dev = _device()
    for D in FA.HEAD_DIMS:
        assert FA.flash_tiles(torch.float32, D) == (32, 32 if D >= 128 else 64)
        assert FA.flash_tiles(torch.bfloat16, D) == (64, 32 if D == 256
                                                     else 64)
    for esize in (2, 4):
        chunk = FA.paged_chunk(16, 256, esize, 20, 8)
        assert FA.paged_smem(esize, 8, 256, 16, chunk) > 0
    assert FA.paged_smem(4, 1, 256, 512, 1) == -1
    ops = _paged_operands(1, 1, 1, 1, 256, 512, 1, [5], torch.float32, dev)
    before = FA.launches
    with pytest.raises(ValueError, match="shared memory"):
        FA.paged_flash_attention(*ops)
    assert FA.launches == before


@pytest.mark.cuda
def test_engine_kernel_path_launches_b3_per_layer_per_step():
    """gemma-2b reduced on the card: the kernel path gives the gather
    path's greedy tokens and launches B3 once per layer per decode step;
    B1 and B2 stay idle."""
    dev = _device()
    from repro_torch.configs import get
    from repro_torch.models import model as lm
    from repro_torch.serve import Engine, Request, ServeConfig

    cfg = get("gemma-2b").reduced()
    params = lm.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    scfg = ServeConfig(max_batch=4, block_size=8, num_blocks=64,
                       max_blocks_per_seq=8, prompt_buckets=(8, 16, 32))
    rs = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rs.randint(1, cfg.vocab_size,
                                             3 + 7 * i).tolist(), max_new=5)
            for i in range(5)]
    outs = {}
    for impl in ("gather", "kernel"):
        eng = Engine(cfg, scfg, params, attn_impl=impl)
        FA.reset_launches()
        Q.reset_launches()
        outs[impl] = eng.run(reqs)
        launches = FA.launches
        assert (Q.launches, Q.launches_dyn) == (0, 0)
        assert launches == (eng.steps * cfg.num_layers
                            if impl == "kernel" else 0), (impl, launches)
    assert outs["kernel"] == outs["gather"]


def _flash_operands(seed, BH, S, D, dtype, dev):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(BH, S, D).astype(np.float32))
            .to(dev, dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,blk", [(24, 8), (128, 128), (1024, 128)])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(S, blk, D, causal,
                                                      dtype):
    """B4 against its plain version on the same tensors: float32 within
    2e-4 (the JAX test's), bfloat16 within one bf16 ulp of the output's
    magnitude (both compute in float32 and round once)."""
    dev = _device()
    q, k, v = _flash_operands(S + D, 3, S, D, dtype, dev)
    before = (FA.flash_launches, FA.launches)
    got = FA.flash_attention(q, k, v, causal=causal, bq=blk, bk=blk)
    assert (FA.flash_launches, FA.launches) == (before[0] + 1, before[1])
    want = flash_attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal)[:, :, 0]
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-4 if dtype == torch.float32 else _bf16_ulp(want.float())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S,blk", [(1, 1), (8, 8), (24, 8)])
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_below_one_tile(S, blk, D, causal, dtype):
    """S below one of the kernel's tiles (and S = 24 with the JAX kernel's
    8-row tiles) at every head dim: the tolerances above."""
    dev = _device()
    q, k, v = _flash_operands(S + D, 2, S, D, dtype, dev)
    before = FA.flash_launches
    got = FA.flash_attention(q, k, v, causal=causal, bq=blk, bk=blk)
    assert FA.flash_launches == before + 1
    want = flash_attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal)[:, :, 0]
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-4 if dtype == torch.float32 else _bf16_ulp(want.float())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_flash_attention_counts_only_its_launches():
    dev = _device()
    q, k, v = _flash_operands(1, 2, 64, 32, torch.float32, dev)
    FA.reset_launches()
    for _ in range(3):
        FA.flash_attention(q, k, v, bq=32, bk=32)
    FA.flash_attention(q.cpu(), k.cpu(), v.cpu(), bq=32, bk=32)
    assert (FA.flash_launches, FA.launches) == (3, 0)
    FA.reset_launches()
    assert FA.flash_launches == 0


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    dev = _device()
    q, k, v = _flash_operands(0, 2, 128, 64, torch.float32, dev)
    before = FA.flash_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="is on"):
        FA.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="D in"):
        FA.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    with pytest.raises(ValueError, match="bq=48"):
        FA.flash_attention(q, k, v, bq=48)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.zeros(q.numel() + 4, device=dev)[1:1 + q.numel()]
        FA.flash_attention(q, shifted.view(q.shape), v)
    assert FA.flash_launches == before


# --------------------------------------------------------------------------- #
# the workers over NCCL, and the exchange overlapped on a side stream
# --------------------------------------------------------------------------- #
def _nccl_mesh():
    """A one-rank NCCL group in this process (the caller closes it)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import ProcessMesh
    return ProcessMesh.init(0, 1, device_type="cuda", store=dist.HashStore())


@pytest.mark.cuda
def test_nccl_collectives_match_the_stacked_backend():
    """One rank holding all four workers: every collective goes through
    NCCL and gives what the stacked backend gives."""
    from repro_torch.core import exchange as X
    dev = _device()
    mesh = _nccl_mesh()
    try:
        wk, st = X.ProcessGroupWorkers(mesh, 4), X.StackedWorkers(4)
        assert (wk.n, wk.n_local, wk.offset) == (4, 4, 0)
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(4, 33, 7).astype(np.float32)).to(dev)
        y = torch.from_numpy(rs.randn(4, 4, 5).astype(np.float32)).to(dev)
        c = torch.from_numpy(rs.randint(-127, 128, (4, 9)).astype(
            np.int8)).to(dev)
        hm, hg, ha = (wk.start_mean(x), wk.start_all_gather(c),
                      wk.start_all_to_all(y))
        assert torch.equal(ha.wait(), st.all_to_all(y))
        assert torch.equal(hg.wait(), st.all_gather(c))
        torch.testing.assert_close(hm.wait(), st.mean(x), rtol=0, atol=1e-6)
        assert float(wk.max(x[:, 0, 0])) == float(st.max(x[:, 0, 0]))
    finally:
        mesh.close()


def _mixture_run(dev, strat, W, steps=4, mesh=None, seed=0):
    """(named final state, launches (B1, B2)) of the mixture MLP GAN."""
    from repro_torch import checkpoint as CK
    from repro_torch.configs.base import DQConfig
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    cfg = gan.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                        hidden=128)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=1e-2), device=dev, workers=W, mesh=mesh)
    st = tr.init(gan.init(cfg, generator=gen, device=dev))
    Q.reset_launches()
    for _ in range(steps):
        st = tr.step(st, {"real": torch.randn((64, 2), generator=gen,
                                              device=dev)}).state
    torch.cuda.synchronize()
    return dict(CK._paths(st)), (Q.launches, Q.launches_dyn), tr


def _delayed(kind, W, overlap=False):
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Schedule, Strategy)
    if W == 1:
        return Strategy(compression=Compression(
            compressor="qsgd8_block1024", plan="uniform", bucket_mb=0.03),
            exchange=ExchangePlan(kind=kind, worker_axes=(),
                                  overlap=overlap),
            schedule=Schedule.delayed(2))
    return Strategy(compression=Compression(
        compressor="qsgd8_block1024", plan="delta_budget", budget_mb=0.033,
        bucket_mb=0.03, adaptive=True),
        exchange=ExchangePlan(kind=kind, overlap=overlap),
        schedule=Schedule.delayed_hetero((1, 2, 3, 4)),
        participation=Participation(fraction=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sim", "allgather", "two_phase"])
def test_dqgan_over_nccl_matches_the_stacked_workers(kind):
    """Four workers on one NCCL rank against four stacked, the τ-vector
    run: B2 launches alike, versions equal, the states within the port's
    tolerances (here bit-equal but for the all_reduce's order)."""
    dev = _device()
    strat = _delayed(kind, 4)
    ref, ref_l, tr = _mixture_run(dev, strat, 4)
    mesh = _nccl_mesh()
    try:
        got, got_l, _ = _mixture_run(dev, strat, 4, mesh=mesh)
    finally:
        mesh.close()
    assert ref_l == got_l and ref_l[1] > 0 and ref_l[0] == 0
    assert list(ref) == list(got)
    assert torch.equal(ref["sched/versions"], got["sched/versions"])
    emax = max(v.abs().max().item() for k, v in ref.items()
               if k.endswith("/e1") or k.endswith("/e2"))
    for k, v in ref.items():
        if k.startswith("params/"):
            torch.testing.assert_close(got[k], v, rtol=0, atol=emax + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("W,kind", [(1, "sim"), (1, "two_phase"),
                                    (4, "sim"), (4, "two_phase")])
def test_overlap_on_the_card_is_bit_exact(W, kind):
    """delayed with the exchange started on a side stream before the
    field: the same state, bit for bit, and the same kernel launches (B1
    for one worker, B2 for four) as the blocking order."""
    dev = _device()
    off, off_l, _ = _mixture_run(dev, _delayed(kind, W), W, steps=6)
    on, on_l, tr = _mixture_run(dev, _delayed(kind, W, overlap=True), W,
                                steps=6)
    assert tr._side is not None     # the side stream was used
    assert off_l == on_l and sum(on_l) > 0
    assert list(off) == list(on)
    for k, v in off.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(on[k], v), k
        else:
            assert on[k] == v, k


@pytest.mark.cuda
@pytest.mark.parametrize("W,kind", [(1, "sim"), (4, "sim"),
                                    (4, "two_phase")])
def test_obs_full_on_the_card_leaves_the_state_bit_equal(W, kind):
    """metrics off against full with spans on, delayed through B1 (one
    worker) or B2 (four, the τ-vector, half reporting): the same state,
    bit for bit, and the same kernel launches."""
    dev = _device()
    strat = _delayed(kind, W)
    off, off_l, _ = _mixture_run(dev, strat, W)
    full, full_l, _ = _mixture_run(
        dev, strat.evolve(obs_metrics="full", obs_spans=True), W)
    assert off_l == full_l and sum(off_l) > 0
    assert list(off) == list(full)
    for k, v in off.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(full[k], v), k
        else:
            assert full[k] == v, k


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_obs_delta_equals_the_plain_quantizer_on_its_operands(W):
    """bucket_delta of each step against 1 − Σe'²/Σm² with e' from the
    plain version of B1 (one worker, one launch over the packed buckets)
    or B2 (four workers, one launch a bucket) on the operands the kernel
    was given: to float32 rounding (atol 1e-6)."""
    from unittest import mock
    from repro_torch.configs.base import DQConfig
    from repro_torch.core import error_feedback as EF
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    dev = _device()
    cfg = gan.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                        hidden=128)
    gen = torch.Generator(device=dev).manual_seed(1)
    strat = _delayed("sim", W).evolve(obs_metrics="full")
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=1e-2), device=dev, workers=W)
    st = tr.init(gan.init(cfg, generator=gen, device=dev))
    layout = tr._comm(st.params)[0]
    calls, real = [], EF.quantize_ef_flat

    def spy(g, e, rand, *, levels=127):
        calls.append((g.clone(), e.clone(), rand.clone(), levels))
        return real(g, e, rand, levels=levels)
    with mock.patch.object(EF, "quantize_ef_flat", spy):
        for _ in range(4):
            calls.clear()
            out = tr.step(st, {"real": torch.randn((64, 2), generator=gen,
                                                   device=dev)})
            st = out.state
            want = []
            for g, e, r, lv in calls:
                g, e, r = (x.reshape(-1, 1024) for x in (g, e, r))
                _, _, e_new = quantize_ef_ref(g, e, r, lv)
                m = g + e
                rows = ([b.size // 1024 for b in layout.buckets]
                        if len(calls) == 1 else [g.shape[0]])
                # an empty wire (the delayed ring's first heads) reads 1
                want += [1.0 - float((eb * eb).sum())
                         / max(float((mb * mb).sum()), 1e-30)
                         for mb, eb in zip(m.split(rows), e_new.split(rows))]
            got = out.metrics["obs"]["bucket_delta"].tolist()
            assert len(calls) == (1 if W == 1 else len(layout.buckets))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_obs_device_phases_hold_the_fields_backward(W, tmp_path):
    """On CUDA autograd runs the field's backward on its own thread: the
    field phase of a captured step (spans on) holds every kernel of the
    W field calls made on their own, and the phases with the kernels
    outside them add up to the kernels the capture holds."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import DQConfig
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    from repro_torch.obs.profile import phase_costs
    dev = _device()
    cfg = gan.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                        hidden=128)
    gen = torch.Generator(device=dev).manual_seed(1)
    strat = _delayed("sim", W).evolve(obs_metrics="full", obs_spans=True)
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=1e-2), device=dev, workers=W)
    st = tr.init(gan.init(cfg, generator=gen, device=dev))
    batch = {"real": torch.randn((64, 2), generator=gen, device=dev)}
    st = tr.step(st, batch).state
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def kernels(prof):
        import json
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return sum(1 for e in json.load(fh)["traceEvents"]
                       if e.get("cat") == "kernel")
    with profile(activities=acts) as prof:
        tr.step(st, batch)
        torch.cuda.synchronize()
    z = tr.field_fn.draw_z({"real": batch["real"][:64 // W]}, gen)
    with profile(activities=acts) as alone:
        for _ in range(W):
            tr.field_fn(st.params, {"real": batch["real"][:64 // W]}, z=z)
        torch.cuda.synchronize()
    costs = phase_costs(prof, cuda=True)
    # cuDNN and cuBLAS may launch a kernel more or less from call to call
    field = kernels(alone)
    assert field > 0 and abs(costs["field"]["ops"] - field) <= 0.02 * field
    assert sum(v["ops"] for v in costs.values()) == kernels(prof)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_phase_clock_device_times_nest(W):
    """Spans on, a phase clock over 3 steps (one worker B1, four B2): every
    device time is non-negative and each span's device interval lies
    inside its parent's (all on one stream); a step's busy time is no
    more than the window's wall a step."""
    from repro_torch.configs.base import DQConfig
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    from repro_torch.obs.tracing import PhaseClock
    dev = _device()
    cfg = gan.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                        hidden=128)
    gen = torch.Generator(device=dev).manual_seed(1)
    strat = _delayed("sim", W).evolve(obs_spans=True)
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg), dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=1e-2), device=dev, workers=W)
    st = tr.init(gan.init(cfg, generator=gen, device=dev))
    batch = {"real": torch.randn((64, 2), generator=gen, device=dev)}
    st = tr.step(st, batch).state
    torch.cuda.synchronize()
    clock = PhaseClock(dev).start()
    try:
        for _ in range(3):
            st = tr.step(st, batch).state
            clock.end_step()
        torch.cuda.synchronize()
    finally:
        r = clock.stop()
    assert r.n_steps == 3
    assert {"lookahead", "field", "message", "exchange", "compress", "apply",
            "carry"} <= set(r.phases)
    eps = 1e-3      # ms: the events' resolution is about half a microsecond
    for s in r.spans:
        assert 0 <= s.device_in <= s.device_out, s
        if s.parent is not None:
            p = r.spans[s.parent]
            assert p.device_in - eps <= s.device_in, (p, s)
            assert s.device_out <= p.device_out + eps, (p, s)
    for rec in r.phases.values():
        assert rec["device_ms"] >= rec["device_self_ms"] >= -eps
    assert 0 < r.busy_ms_per_step() <= r.wall_ms / r.n_steps + eps


@pytest.mark.cuda
@pytest.mark.parametrize("W,shard_rows", [(4, (162, 162, 128)),
                                          (1, (648, 648, 512))])
def test_fsdp_all_gather_leg_b1_matches_plain_version(W, shard_rows):
    """The fsdp all-gather leg at dcgan32's shard shapes (four workers:
    (162, 162, 128) rows of 1024 a worker; one: the buckets): one B1
    launch a bucket over all W owners' rows, the payload and the owners'
    residual bit-equal to the plain version on the same operands; the
    gathered bucket is the payload's decompression on every worker, and
    with one worker the owner's own dequantization (codes · (s / L), IEEE
    division), as in the JAX package."""
    from repro_torch.core import compressors as C
    from repro_torch.core import exchange as X
    dev = _device()
    comp = C.get("qsgd8_block1024")
    for i, rows in enumerate(shard_rows):
        g, e, r = (x.reshape(W, rows * 1024)
                   for x in _operands(i, W * rows, 1024, dev))
        before = Q.launches
        h = X.start_all_gather_shard(comp, g, e, r, X.StackedWorkers(W),
                                     True)
        full, age = h.finish()
        assert Q.launches == before + 1
        cp, sp, ep = quantize_ef_ref(g.reshape(-1, 1024), e.reshape(-1, 1024),
                                     r.reshape(-1, 1024), 127)
        assert torch.equal(age, ep.reshape(W, -1))
        if W == 1:
            want = (cp.float() * (sp / sp.new_tensor(127.0))).reshape(-1)
        else:
            want = comp.decompress({"codes": cp, "scale": sp},
                                   (W * rows * 1024,), torch.float32)
        assert torch.equal(full, want)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_fsdp_step_runs_b1_on_the_all_gather_leg(W):
    """Compressed zero-3 (two_phase, a block-1024 moment compressor) on the
    mixture GAN: B1 once a bucket on the all-gather leg, and at W = 1 once
    a bucket on the reduce-scatter leg too (at W > 1 that leg rounds with
    the registry compressor); never B2."""
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      MomentCompression, Strategy)
    dev = _device()
    strat = Strategy(
        compression=Compression(compressor="qsgd8_block1024",
                                plan="uniform", bucket_mb=0.03),
        exchange=ExchangePlan(kind="two_phase", parallelism="fsdp",
                              zero_stage=3,
                              worker_axes=("data",) if W > 1 else ()),
        moments=MomentCompression(compressor="qsgd8_block1024"))
    state, launches, _ = _mixture_run(dev, strat, W, steps=3)
    n_buckets = sum(1 for k in state if k.endswith("/age"))
    assert n_buckets > 1
    assert launches == ((2 if W == 1 else 1) * 3 * n_buckets, 0)
    assert all(torch.isfinite(v).all() for k, v in state.items()
               if k.startswith("params/"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_weights_on_the_card(dtype):
    """Load-time quantization on the card: B1 once a bucket, codes and
    scales bit-equal to B1's plain version on the same draws, and the
    rebuilt tree bit-equal to the CPU's rebuild of the same payload (the
    step s/L an IEEE division on both devices, the product rounded once
    to the leaves' dtype)."""
    import dataclasses
    from unittest import mock

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.models import model as lm
    from repro_torch.serve import quantized_weights as QW
    from repro_torch.strategy import Compression
    dev = _device()
    cfg = dataclasses.replace(configs.get("gemma-2b").reduced(),
                              param_dtype=dtype)
    params = lm.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        0), device=dev)
    comp = Compression(compressor="qsgd8_linf", plan="uniform",
                       bucket_mb=0.25)
    before = Q.launches
    meta, pay = QW.quantize_weights(params, comp, seed=3)
    assert Q.launches - before == len(meta.layout.buckets)

    def plain(g, e, rand, *, levels=127):
        c, s, en = quantize_ef_ref(g.reshape(-1, 1024), e.reshape(-1, 1024),
                                   rand.reshape(-1, 1024), levels)
        return c.reshape(-1), s.reshape(-1), en.reshape(-1)

    with mock.patch.object(QW, "quantize_ef_flat", plain):
        _, want = QW.quantize_weights(params, comp, seed=3)
    for k in pay:
        for f in pay[k]:
            assert torch.equal(pay[k][f], want[k][f]), (k, f)
    got = QW.dequantize_weights(meta, pay)
    ref = QW.dequantize_weights(meta, {k: {f: x.cpu() for f, x in v.items()}
                                       for k, v in pay.items()})
    for a, b in zip(T.leaves(got), T.leaves(ref)):
        assert a.dtype == getattr(torch, dtype)
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen3-moe-30b-a3b"])
def test_lm_field_on_the_card_matches_the_cpu(arch):
    """The LM field (loss, MoE aux losses, gradients) of a reduced arch in
    float32 on the card, TF32 off, against the same field on the CPU:
    each within 1e-4 of the CPU tree's largest |g| (the card's GEMMs sum
    in another order)."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import build
    dev = _device()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(arch).reduced()
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = bundle.init(generator=gen)
    batch = synthetic_lm_batch(4, 32, cfg.vocab_size, generator=gen)
    g_cpu, m_cpu = bundle.field_fn(params, batch)
    g_dev, m_dev = bundle.field_fn(
        T.tree_map(lambda x: x.to(dev), params),
        {k: v.to(dev) for k, v in batch.items()})
    assert sorted(m_dev) == sorted(m_cpu)
    for k in m_cpu:
        torch.testing.assert_close(m_dev[k].cpu(), m_cpu[k], rtol=1e-5,
                                   atol=1e-6)
    gmax = max(x.abs().max().item() for x in T.leaves(g_cpu))
    for a, b in zip(T.leaves(g_dev), T.leaves(g_cpu)):
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * gmax


@pytest.mark.cuda
def test_lm_dqgan_steps_run_b1_once_a_step_bit_equal_to_plain():
    """Reduced starcoder2 in bfloat16 through the trainer on the card
    (omd, qsgd8_block1024 over uniform buckets): B1 once a step, and the
    same two steps with B1's plain version give bit-equal parameters (the
    field is deterministic on the card: the GQA repeat's and the
    embedding's backward sum in a fixed order)."""
    import dataclasses
    from unittest import mock

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.configs import DQConfig
    from repro_torch.core import dqgan, error_feedback
    from repro_torch.data import lm_batch_iterator
    from repro_torch.models import build
    from repro_torch.strategy import Compression, Strategy
    dev = _device()
    cfg = dataclasses.replace(configs.get("starcoder2-7b").reduced(),
                              param_dtype="bfloat16", num_kv_heads=2)
    bundle = build(cfg)
    strat = Strategy(compression=Compression(compressor="qsgd8_block1024",
                                             plan="uniform", bucket_mb=1.0))

    def run():
        tr = dqgan.DQGAN(field_fn=bundle.field_fn, dq=DQConfig.from_strategy(
            strat, optimizer="omd", lr=1e-3, message="update"), device=dev,
            seed=1)
        gen = torch.Generator(device=dev).manual_seed(0)
        st = tr.init(bundle.init(generator=gen, device=dev))
        it = lm_batch_iterator(4, 64, cfg.vocab_size, generator=gen,
                               device=dev)
        for _ in range(2):
            st = tr.step(st, next(it)).state
        return T.leaves(st.params)

    def plain(g, e, rand, *, levels=127):
        c, s, en = quantize_ef_ref(g.reshape(-1, 1024), e.reshape(-1, 1024),
                                   rand.reshape(-1, 1024), levels)
        return c.reshape(-1), s.reshape(-1), en.reshape(-1)

    before = Q.launches
    kern = run()
    assert Q.launches - before == 2
    with mock.patch.object(error_feedback, "quantize_ef_flat", plain):
        ref = run()
    assert Q.launches - before == 2
    for a, b in zip(kern, ref):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# B5: the chunked SSD
# --------------------------------------------------------------------------- #
def _ssd_operands(seed, B, T, H, P, N, dtype, dev, big=False):
    """x, B and C as views of one (B, T, H·P + 2N) tensor (the mixer's conv
    output), dt = softplus(·) float32, A < 0 and D (H,), dy and dh. `big`:
    |A·dt| near 6 a position, so that exp(cum_l − cum_m) above the diagonal
    would overflow."""
    rs = np.random.RandomState(seed)
    di = H * P
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    xbc = f(B, T, di + 2 * N).to(dev, dtype)
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = torch.nn.functional.softplus(f(B, T, H) + (2.0 if big else -1.0))
    A = -torch.exp(f(H) * 0.5 + (1.0 if big else 0.0))
    D = f(H)
    dy = f(B, T, di).to(dev, dtype)
    dh = f(B, H, P, N)
    return x, Bm, Cm, dt.to(dev), A.to(dev), D.to(dev), dy, dh.to(dev)


def _ssd_grads(fn, ops, P, L, dtype=None):
    """y, h and the gradients of <y, dy> + <h, dh> for x, B, C, dt, A, D
    through `fn` (the kernel's wrapper or the plain version), the operands
    cast to `dtype` where given."""
    x, Bm, Cm, dt, A, D, dy, dh = ops
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    leaves = [cast(t).detach().requires_grad_() for t in (x, Bm, Cm, dt, A,
                                                          D)]
    y, h = fn(*leaves, P, L)
    loss = (y.float() * cast(dy).float()).sum() + (h * cast(dh)).sum()
    return [y.detach(), h.detach()] + list(torch.autograd.grad(loss, leaves))


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


SSD_NAMES = ("y", "h", "dx", "dB", "dC", "ddt", "dA", "dD")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,L,dtype", [
    (2, 2048, 64, 64, 128, 256, "bfloat16"),   # mamba2-1.3b's training cell
    (2, 2048, 64, 64, 128, 256, "float32"),
    (2, 2048, 32, 64, 128, 256, "bfloat16"),   # one of two model ranks
    (2, 64, 32, 16, 16, 32, "float32"),        # the reduced config
    (2, 64, 32, 16, 16, 32, "bfloat16"),
    (2, 35, 4, 16, 16, 7, "float32"),          # T = 35 at chunk 7
    (1, 512, 8, 128, 32, 256, "float32"),      # P 128: two channel tiles
    (3, 96, 5, 32, 64, 96, "bfloat16")])       # odd heads, a partial tile
def test_ssd_kernel_matches_plain_version(B, T, H, P, N, L, dtype):
    """B5 against its plain version on the card: y, the final state and
    the gradients of x, B, C, dt, A and D, each as a norm-relative gap. Both
    sum in float32 in different orders (float32 operands: 2e-4); in
    bfloat16, y, dx, dB and dC are rounded to bfloat16 by both (5e-3), the
    float32 ones are not (1e-3). One forward and one backward launch."""
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels.ref import ssd_chunked_ref
    dev = _device()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt_ = getattr(torch, dtype)
    ops = _ssd_operands(T + H, B, T, H, P, N, dt_, dev)
    before = (SSD.ssd_launches, SSD.ssd_bwd_launches)
    got = _ssd_grads(SSD.ssd_chunked, ops, P, L)
    assert (SSD.ssd_launches, SSD.ssd_bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = _ssd_grads(ssd_chunked_ref, ops, P, L)
    torch.cuda.synchronize()
    for name, a, b in zip(SSD_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        tol = (2e-4 if dtype == "float32" else
               5e-3 if a.dtype == torch.bfloat16 else 1e-3)
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,L,dtype", [
    (2, 2048, 64, 64, 128, 256, "bfloat16"),   # mamba2-1.3b's training cell
    (3, 96, 5, 32, 64, 96, "float32")])        # odd heads, a partial tile
def test_ssd_kernel_is_deterministic(B, T, H, P, N, L, dtype):
    """B5 twice on the same operands: y, the final state and every
    gradient bit-equal. No kernel adds to memory by atomics; where CTAs
    share a sum, each writes its part to a slot and one kernel sums the
    slots in a fixed order, so a seeded training run repeats bit for
    bit."""
    from repro_torch.kernels import ssd as SSD
    dev = _device()
    ops = _ssd_operands(T * H, B, T, H, P, N, getattr(torch, dtype), dev)
    first = _ssd_grads(SSD.ssd_chunked, ops, P, L)
    for _ in range(2):
        again = _ssd_grads(SSD.ssd_chunked, ops, P, L)
        for name, a, b in zip(SSD_NAMES, first, again):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_ssd_kernel_gradients_finite_at_chunk_256_with_large_decays():
    """C4 on the card: at chunk 256 with |A·dt| near 6 a position (masked
    exponents far above float32's range) every gradient is finite, and the
    kernel is as close to a float64 evaluation of the plain version as the
    float32 plain version is (within twice its gap, or 1e-5)."""
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels.ref import ssd_chunked_ref
    dev = _device()
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _ssd_operands(5, 1, 512, 4, 64, 128, torch.float32, dev, big=True)
    got = _ssd_grads(SSD.ssd_chunked, ops, 64, 256)
    f32 = _ssd_grads(ssd_chunked_ref, ops, 64, 256)
    f64 = _ssd_grads(_ssd_ref64, ops, 64, 256, dtype=torch.float64)
    for name, a, b, c in zip(SSD_NAMES, got, f32, f64):
        assert torch.isfinite(a).all(), name
        assert _rel(a, c) <= max(2 * _rel(b, c), 1e-5), (name, _rel(a, c),
                                                          _rel(b, c))


def _ssd_ref64(x, Bm, Cm, dt, A, D, P, L):
    """The plain version's arithmetic in float64 (its casts to float32
    turned to float64)."""
    import inspect
    import math
    import textwrap

    from repro_torch.kernels import ref
    src = textwrap.dedent(inspect.getsource(ref.ssd_chunked_ref))
    src = (src.replace(".float()", ".double()")
           .replace("torch.float32", "torch.float64")
           .replace("def ssd_chunked_ref", "def _f"))
    ns = {"torch": torch, "math": math}
    exec(src, ns)
    return ns["_f"](x, Bm, Cm, dt, A, D, P, L)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take():
    from repro_torch.kernels import ssd as SSD
    dev = _device()
    x, Bm, Cm, dt, A, D, _, _ = _ssd_operands(0, 1, 64, 2, 16, 16,
                                              torch.float32, dev)
    before = (SSD.ssd_launches, SSD.ssd_bwd_launches)
    with pytest.raises(ValueError, match="P and N"):      # P = 8
        SSD.ssd_chunked(x, Bm, Cm, dt.repeat(1, 1, 2), A.repeat(2),
                        D.repeat(2), 8, 32)
    with pytest.raises(ValueError, match="P and N"):      # N = 8
        SSD.ssd_chunked(x, Bm[..., :8], Cm[..., :8], dt, A, D, 16, 32)
    with pytest.raises(ValueError, match="chunk of 1 to 256"):
        SSD.ssd_chunked(x.repeat(1, 8, 1), Bm.repeat(1, 8, 1),
                        Cm.repeat(1, 8, 1), dt.repeat(1, 8, 1), A, D, 16,
                        512)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        SSD.ssd_chunked(x.half(), Bm.half(), Cm.half(), dt, A, D, 16, 32)
    with pytest.raises(TypeError, match="one dtype"):
        SSD.ssd_chunked(x, Bm.bfloat16(), Cm, dt, A, D, 16, 32)
    assert (SSD.ssd_launches, SSD.ssd_bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_copies_operands_it_cannot_load(dtype):
    """x, B and C as a model rank of 16 holds them for the reduced config
    (views of rows of H·P + 2 elements, not whole 16 bytes apart) and B
    strided along its channels: the wrapper hands the kernels contiguous
    copies, and every output and gradient equals the contiguous operands'
    bit for bit."""
    from repro_torch.kernels import ssd as SSD
    dev = _device()
    B, T, H, P, N = 2, 64, 2, 16, 16
    ops = _ssd_operands(11, B, T, H, P, N, getattr(torch, dtype), dev)
    x, Bm, Cm = ops[:3]
    rows = torch.cat([x, Bm[..., :1], Cm[..., :1]], -1)   # H·P + 2 a row
    odd = (rows[..., :H * P],
           Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm)
    want = _ssd_grads(SSD.ssd_chunked, ops, P, 32)
    got = _ssd_grads(SSD.ssd_chunked, odd + ops[3:], P, 32)
    for name, a, b in zip(SSD_NAMES, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_mamba2_dqgan_steps_run_the_ssd_kernel():
    """Reduced mamba2 (2 layers, P 16, N 16, chunk 32) in bfloat16 through
    the trainer on the card: each step runs B5's forward twice a layer
    (the field's forward and its recomputation under remat 'full') and its
    backward once a layer, so 8 and 4 in two steps; the losses are finite
    and B1 runs once a step."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import DQConfig
    from repro_torch.core import dqgan
    from repro_torch.data import lm_batch_iterator
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import build
    from repro_torch.strategy import Compression, Strategy
    dev = _device()
    cfg = dataclasses.replace(configs.get("mamba2-1.3b").reduced(),
                              param_dtype="bfloat16")
    assert cfg.remat == "full" and cfg.num_layers == 2
    bundle = build(cfg)
    strat = Strategy(compression=Compression(compressor="qsgd8_block1024",
                                             plan="uniform", bucket_mb=1.0))
    tr = dqgan.DQGAN(field_fn=bundle.field_fn, dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=1e-3, message="update"), device=dev,
        seed=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    st = tr.init(bundle.init(generator=gen, device=dev))
    it = lm_batch_iterator(4, 64, cfg.vocab_size, generator=gen, device=dev)
    before = (SSD.ssd_launches, SSD.ssd_bwd_launches, Q.launches)
    for _ in range(2):
        out = tr.step(st, next(it))
        st = out.state
        assert torch.isfinite(out.metrics["loss"]).all()
    assert (SSD.ssd_launches - before[0], SSD.ssd_bwd_launches - before[1],
            Q.launches - before[2]) == (8, 4, 2)
