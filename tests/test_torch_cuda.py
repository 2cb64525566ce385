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
