"""The split of B3's and B4's key ranges over a thread block cluster, and the
merge of the CTAs' partial online-softmax results, checked on the CPU.

The CUDA kernels compute their key ranges on the device from the same
formulas as the plan functions of `repro_torch.kernels.flash_attention`
(`paged_split`/`paged_ranges`/`paged_chunk`, `flash_split`/
`flash_ranges`), and merge the partials as `csrc/softmax_merge.cuh` does.
Here the plans are checked for coverage (every live key, and every
(query row, key) pair the mask keeps, in exactly one CTA) and for their
sizes at the shapes the kernels are timed at, and the merge algebra is
replayed in PyTorch: each plain version's keys split by the plan, a
partial (m, l, acc) per CTA, merged with the header's formula, against
the Pallas kernels in interpret mode and the unsplit plain versions,
float32 within 1e-5 (the same sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import paged_flash_attention as j_paged
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref
from torch_ranks import one_thread  # noqa: F401 (autouse)

H100_SMS = 132
MASK = -1e30
# B4's tiles (BQ, BK) by type and head dim, as csrc/flash_attention.cu
# defines them; the card tests hold `FA.flash_tiles` to this table
KERNEL_TILES = {
    torch.float32: {16: (32, 64), 32: (32, 64), 64: (32, 64),
                    128: (32, 32), 256: (32, 32)},
    torch.bfloat16: {16: (64, 64), 32: (64, 64), 64: (64, 64),
                     128: (64, 64), 256: (64, 32)},
}


# --------------------------------------------------------------------------- #
# The merge of csrc/softmax_merge.cuh, and partials over a key range
# --------------------------------------------------------------------------- #
def merge(parts):
    """[(m (R,), l (R,), acc (R, D))] -> (R, D): M = max m_i, l = sum
    exp(m_i - M) l_i, acc = sum exp(m_i - M) acc_i, acc / max(l, 1e-20)."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi[:, None] * ai for wi, (_, _, ai) in zip(w, parts))
    return acc / torch.clamp(l, min=1e-20)[:, None]


def partial(s, keep, v):
    """(m, l, acc) of one CTA: scores s (R, n) already scaled, `keep` (R, n)
    the keys the mask keeps, values v (n, D). An empty range gives
    m = -1e30, l = 0, acc = 0."""
    R, D = s.shape[0], v.shape[1]
    if s.shape[1] == 0:
        return (torch.full((R,), MASK), torch.zeros(R), torch.zeros(R, D))
    s = torch.where(keep, s, MASK)
    m = s.amax(1)
    p = torch.where(keep, torch.exp(s - m[:, None]), 0.0)
    return m, p.sum(1), p @ v


# --------------------------------------------------------------------------- #
# B3: plans
# --------------------------------------------------------------------------- #
def test_paged_plan_at_the_serving_shape():
    """gemma-2b serving: B = 16 rows, one kv head, 20 blocks of 16 a row,
    contexts 257..319: clusters of 8 (128 CTAs on 132 SMs), shares of 2-3
    blocks, each staged whole in both types (the card tests check that it
    fits the kernel's shared memory)."""
    c = FA.paged_split(16, 1, 20, H100_SMS)
    assert c == 8 and 16 * c <= H100_SMS
    lengths = [257 + 4 * i for i in range(15)] + [319]
    for row in FA.paged_ranges(lengths, 16, 20, c):
        assert {hi - lo for lo, hi in row} <= {2, 3}
    for esize in (2, 4):
        chunk = FA.paged_chunk(16, 256, esize, 20, c)
        assert chunk == 3
        assert 2 * chunk * 16 * 256 * esize <= FA.PAGED_STAGE_BYTES


@pytest.mark.parametrize("B,Kh,maxb,sms,want", [
    (16, 1, 20, 132, 8),     # the serving shape
    (8, 1, 20, 132, 8),
    (16, 2, 20, 132, 4),     # B·K = 32
    (66, 1, 20, 132, 2),
    (132, 1, 20, 132, 1),    # B·K fills the card
    (200, 4, 20, 132, 1),
    (16, 1, 3, 132, 2),      # no more CTAs than a row has blocks
    (1, 1, 1, 132, 1),
])
def test_paged_cluster_size(B, Kh, maxb, sms, want):
    c = FA.paged_split(B, Kh, maxb, sms)
    assert c == want
    assert 1 <= c <= FA.MAX_CLUSTER and c & (c - 1) == 0
    assert all(D % c == 0 for D in FA.HEAD_DIMS)


@pytest.mark.parametrize("seed", range(4))
def test_paged_ranges_cover_every_live_block_once(seed):
    rs = np.random.RandomState(seed)
    bs, maxb = int(rs.choice([4, 16, 32])), int(rs.randint(1, 40))
    B = int(rs.randint(1, 40))
    lengths = rs.randint(0, bs * maxb + 1, size=B)
    lengths[: min(B, 3)] = [0, 1, bs * maxb][: min(B, 3)]
    c = FA.paged_split(B, 1, maxb, H100_SMS)
    for L, row in zip(lengths, FA.paged_ranges(lengths, bs, maxb, c)):
        assert len(row) == c
        nb = min(-(-int(L) // bs), maxb)
        owners = np.zeros(maxb, int)
        for lo, hi in row:
            assert 0 <= lo <= hi <= nb
            owners[lo:hi] += 1
        assert (owners[:nb] == 1).all() and (owners[nb:] == 0).all()
        # CTAs past the live blocks, and every CTA of an L = 0 row, are empty
        assert sum(hi == lo for lo, hi in row) == max(0, c - nb)
        # contiguous shares in rank order, at most one block apart in size
        assert [lo for lo, _ in row[1:]] == [hi for _, hi in row[:-1]]
        sizes = [hi - lo for lo, hi in row]
        assert max(sizes) - min(sizes) <= 1


def test_paged_chunk_bounds_shared_memory():
    for bs in (4, 16, 32, 64):
        for D in FA.HEAD_DIMS:
            for esize in (2, 4):
                for maxb, c in ((1, 1), (20, 8), (64, 8), (200, 1)):
                    chunk = FA.paged_chunk(bs, D, esize, maxb, c)
                    assert 1 <= chunk <= -(-maxb // c)
                    assert (chunk == 1 or 2 * chunk * bs * D * esize
                            <= FA.PAGED_STAGE_BYTES)


# --------------------------------------------------------------------------- #
# B3: the merge against the Pallas kernel and the plain version
# --------------------------------------------------------------------------- #
def _paged_inputs(seed, B, Kh, G, D, bs, maxb, lengths):
    rs = np.random.RandomState(seed)
    nbs = [-(-L // bs) for L in lengths]
    NB = 1 + sum(nbs)
    perm = rs.permutation(np.arange(1, NB))
    table = np.zeros((B, maxb), np.int32)
    off = 0
    for b, nb in enumerate(nbs):
        table[b, :nb] = perm[off:off + nb]
        off += nb
    return (rs.randn(B, Kh, G, D).astype(np.float32),
            rs.randn(NB, bs, Kh, D).astype(np.float32),
            rs.randn(NB, bs, Kh, D).astype(np.float32), table,
            np.asarray(lengths, np.int32))


def paged_split_merge(q, pk, pv, table, lengths, c):
    """B3 as the kernel computes it: CTA r of each (row, kv head) over its
    share of the live blocks (`paged_ranges`), merged."""
    B, Kh, G, D = q.shape
    bs, maxb = pk.shape[1], table.shape[1]
    out = torch.zeros_like(q)
    for b, row in enumerate(FA.paged_ranges(lengths.tolist(), bs, maxb, c)):
        L = int(lengths[b])
        for h in range(Kh):
            qs = q[b, h] / np.sqrt(D)
            parts = []
            for lo, hi in row:
                blocks = table[b, lo:hi].long()
                k = pk[blocks, :, h].reshape(-1, D)
                v = pv[blocks, :, h].reshape(-1, D)
                pos = torch.arange(lo * bs, hi * bs)
                parts.append(partial(qs @ k.T, (pos < L)[None].expand(G, -1),
                                     v))
            out[b, h] = merge(parts)
    return out


PAGED_CASES = [
    # (label, B, Kh, G, D, bs, maxb, lengths)
    ("ragged, L = 0 and 1", 4, 2, 2, 16, 4, 5, [1, 7, 20, 0]),
    ("share boundary, max context", 3, 1, 4, 32, 4, 8, [16, 32, 8]),
    ("fewer blocks than CTAs", 3, 1, 4, 32, 4, 8, [3, 4, 5]),
    ("MAXB not a multiple of the share", 2, 1, 8, 16, 4, 7, [28, 13]),
]


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_split_merge_matches_pallas_and_plain(case, c):
    _, B, Kh, G, D, bs, maxb, lengths = case
    args = _paged_inputs(len(lengths) + D, B, Kh, G, D, bs, maxb, lengths)
    want = np.asarray(j_paged(*(jnp.asarray(a) for a in args),
                              interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    got = paged_split_merge(*targs, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               paged_attention_ref(*targs).numpy(),
                               rtol=1e-5, atol=1e-5)
    for b, L in enumerate(lengths):
        if L == 0:
            assert float(got[b].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# B4: plans
# --------------------------------------------------------------------------- #
def _cta_keys(S, bq, bk, c, causal):
    """Key counts per CTA, over every q tile."""
    return [hi - lo for row in FA.flash_ranges(S, bq, bk, c, causal)
            for lo, hi in row]


def test_flash_plan_at_the_timed_shapes():
    """(a) the JAX kernel benchmark's full tier, (4, 1024, 128) f32 causal:
    32-row tiles, clusters of 4, 512 CTAs; the longest does 256 keys,
    4.2 MFLOP (16.8 on one CTA unsplit). (d) gemma-2b's prefill call, (8,
    256, 256) bf16 causal: 64-row tiles, clusters of 4 (two key tiles of
    32 a CTA), 128 CTAs; the longest does 64 keys. Neither does more than
    twice the mean work."""
    bq, bk = KERNEL_TILES[torch.float32][128]
    c = FA.flash_split(4, 1024, bq, bk, H100_SMS)
    assert c == 4
    keys = _cta_keys(1024, bq, bk, c, True)
    assert max(keys) == 256 and 4 * 128 * bq * max(keys) == 4194304
    assert max(keys) <= 2 * np.mean(keys)
    bq, bk = KERNEL_TILES[torch.bfloat16][256]
    c = FA.flash_split(8, 256, bq, bk, H100_SMS)
    assert c == 4
    keys = _cta_keys(256, bq, bk, c, True)
    assert max(keys) == 64 and max(keys) <= 2 * np.mean(keys)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S", [(1, 1), (2, 8), (3, 24), (2, 200),
                                  (4, 1024), (64, 4096), (1, 300)])
def test_flash_cluster_size(BH, S, dtype):
    for D in FA.HEAD_DIMS:
        bq, bk = KERNEL_TILES[dtype][D]
        c = FA.flash_split(BH, S, bq, bk, H100_SMS)
        assert 1 <= c <= FA.MAX_CLUSTER and c & (c - 1) == 0 and D % c == 0
        assert c == 1 or 2 * c <= -(-S // bk)  # two key tiles a CTA
        tiles = BH * -(-S // bq)
        if tiles >= 2 * H100_SMS:
            assert c == 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk,c", [(1, 64, 64, 1), (8, 32, 64, 1),
                                       (24, 32, 32, 2), (200, 64, 32, 8),
                                       (256, 64, 64, 4), (1024, 32, 32, 4),
                                       (300, 32, 64, 8)])
def test_flash_ranges_cover_the_mask_once(S, bq, bk, c, causal):
    """Every (query row, key) pair the mask keeps (key <= row when causal)
    falls in exactly one CTA of its q tile; key tiles above the diagonal in
    none; the ranges are whole key tiles but for kend."""
    ranges = FA.flash_ranges(S, bq, bk, c, causal)
    assert len(ranges) == -(-S // bq)
    for t, row in enumerate(ranges):
        assert len(row) == c
        kend = min(S, (t + 1) * bq) if causal else S
        owners = np.zeros(S, int)
        for lo, hi in row:
            assert 0 <= lo <= hi <= kend
            assert lo % bk == 0 and (hi % bk == 0 or hi == kend)
            owners[lo:hi] += 1
        for r in range(t * bq, min(S, (t + 1) * bq)):
            need = r + 1 if causal else S
            assert (owners[:need] == 1).all()
        assert (owners[kend:] == 0).all()


# --------------------------------------------------------------------------- #
# B4: the merge against the Pallas kernel and the plain version
# --------------------------------------------------------------------------- #
def flash_split_merge(q, k, v, causal, bq, bk, c):
    """B4 as the kernel computes it: each q tile's keys split over c CTAs
    (`flash_ranges`), a partial per CTA, merged. q, k, v: (BH, S, D)."""
    BH, S, D = q.shape
    out = torch.zeros_like(q)
    scale = 1.0 / np.sqrt(D)
    for bh in range(BH):
        for t, row in enumerate(FA.flash_ranges(S, bq, bk, c, causal)):
            rows = torch.arange(t * bq, min(S, (t + 1) * bq))
            parts = []
            for lo, hi in row:
                keys = torch.arange(lo, hi)
                s = (q[bh, rows] @ k[bh, lo:hi].T) * scale
                keep = (keys[None] <= rows[:, None] if causal
                        else torch.ones(len(rows), hi - lo, dtype=torch.bool))
                parts.append(partial(s, keep, v[bh, lo:hi]))
            out[bh, rows] = merge(parts)
    return out


FLASH_CASES = [
    # (label, BH, S, D, causal, JAX bq, JAX bk, kernel BQ, BK, c)
    ("bq != bk", 2, 128, 64, True, 128, 64, 32, 64, 4),
    ("bq != bk, full", 2, 128, 64, False, 64, 128, 64, 32, 2),
    ("S = 24, 8-row tiles", 3, 24, 64, True, 8, 8, 32, 64, 1),
    ("S = 24, 8-row tiles, split", 3, 24, 64, True, 8, 8, 8, 8, 2),
    ("S = 24, 8-row tiles, full", 3, 24, 64, False, 8, 8, 16, 8, 2),
    ("long diagonal", 1, 256, 32, True, 128, 128, 64, 32, 8),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_split_merge_matches_pallas_and_plain(case):
    _, BH, S, D, causal, jbq, jbk, bq, bk, c = case
    rs = np.random.RandomState(S + D)
    xs = [rs.randn(BH, S, D).astype(np.float32) for _ in range(3)]
    want = np.asarray(j_flash(*(jnp.asarray(x) for x in xs), causal=causal,
                              bq=jbq, bk=jbk, interpret=True))
    q, k, v = (torch.from_numpy(x) for x in xs)
    got = flash_split_merge(q, k, v, causal, bq, bk, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = flash_attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                                causal=causal)[:, :, 0]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_merge_of_empty_ranges_is_zero_and_of_one_is_the_partial():
    D = 8
    empty = (torch.full((3,), MASK), torch.zeros(3), torch.zeros(3, D))
    assert float(merge([empty, empty]).abs().max()) == 0.0
    rs = np.random.RandomState(0)
    s = torch.from_numpy(rs.randn(3, 5).astype(np.float32))
    v = torch.from_numpy(rs.randn(5, D).astype(np.float32))
    one = partial(s, torch.ones(3, 5, dtype=torch.bool), v)
    want = torch.softmax(s, 1) @ v
    torch.testing.assert_close(merge([one]), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(merge([empty, one, empty]), merge([one]),
                               rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The build cache keys on the headers too
# --------------------------------------------------------------------------- #
def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {n: csrc / p.name for n, p in
                                            _build.SOURCES.items()})
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(p.parent == tmp_path / "build" for p in before.values())
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "softmax_merge.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    # and a new header counts as well
    header.write_bytes(header.read_bytes()[:-len(b"\n// edited\n")])
    assert {n: _build.library_path(n) for n in _build.SOURCES} == before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(_build.library_path(n) != before[n] for n in _build.SOURCES)
