"""Port parity: `repro_torch.serve` (paged KV cache, continuous-batching
engine, sequential baseline) and B3's plain version against `repro.serve`
and `repro.kernels`, on gemma-2b `reduced()` with the JAX weights carried
across by `convert.params_from_jax`.

On the CPU the port's B3 wrapper runs its plain version
(`kernels.ref.paged_attention_ref`), so these tests pin the function the
CUDA kernel computes; the kernel itself is held against the plain version
on the card by `chip_smoke.py` and `tests/test_torch_cuda.py`.

Tolerances: B3 within 2e-5 (the JAX test's; float32 sums in another
order). Greedy tokens exactly: the logits agree to float32 rounding, far
below the gaps between the largest logits of these weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.kernels.flash_attention import paged_flash_attention as j_paged
from repro.kernels.ref import paged_attention_ref as j_paged_ref
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.serve import (
    BlockAllocator,
    Engine,
    Request,
    SequentialGenerator,
    ServeConfig,
    ServeError,
    floor_bucket,
    plan_request,
    required_tokens,
)
from repro_torch.serve.engine import draw_seed, sample_token

JCFG = jcfgs.get("gemma-2b").reduced()
TCFG = tcfgs.get("gemma-2b").reduced()
SCFG = ServeConfig(max_batch=4, block_size=8, num_blocks=64,
                   max_blocks_per_seq=8, prompt_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def weights():
    params = JM.init(jax.random.key(0), JCFG, 0)
    return params, params_from_jax(jax.device_get(params))


def _requests(n, rng, max_new=None, cls=Request):
    return [cls(rid=i,
                prompt=[int(t) for t in rng.integers(1, JCFG.vocab_size,
                                                     int(rng.integers(3, 40)))],
                max_new=int(max_new or rng.integers(1, 8)))
            for i in range(n)]


def _run_churn(eng, reqs):
    """Three requests up front, the rest joining mid-stream while earlier
    ones are still decoding (and some have left): tests/test_serve.py's
    scenario."""
    for r in reqs[:3]:
        eng.submit(r)
    for r in reqs[3:]:
        eng.step()
        eng.submit(r)
    while not eng.idle:
        assert eng.step()
    return eng.outputs


# --------------------------------------------------------------------------- #
# allocator + sizing (tests/test_serve.py's cases)
# --------------------------------------------------------------------------- #
def test_allocator_reuse_oom_double_free():
    a = BlockAllocator(8)                       # blocks 1..7 allocatable
    assert a.capacity == 7
    xs = a.alloc(7)
    assert sorted(xs) == list(range(1, 8)) and a.free_blocks == 0
    with pytest.raises(ServeError, match="out of KV blocks"):
        a.alloc(1)
    a.free(xs[:3])
    assert a.free_blocks == 3 and a.occupancy() == pytest.approx(4 / 7)
    ys = a.alloc(3)                             # recycled ids, no growth
    assert set(ys) <= set(xs[:3])
    a.free([xs[3]])
    with pytest.raises(ServeError, match="double free"):
        a.free([xs[3]])


def test_sizing_floor_bucket_and_validation():
    assert floor_bucket(5, SCFG) == 0           # shorter than every bucket
    assert floor_bucket(8, SCFG) == 8
    assert floor_bucket(31, SCFG) == 16
    assert floor_bucket(200, SCFG) == 32
    assert required_tokens(10, 1, SCFG) == 10   # token 0 is free
    assert required_tokens(10, 5, SCFG) == 14
    assert plan_request(20, 5, SCFG) == (16, 3)  # 24 tokens / bs=8
    with pytest.raises(ServeError, match="max_context"):
        plan_request(32, 64, SCFG)              # 95 > 64 = 8*8
    with pytest.raises(ServeError, match="gen_steps"):
        required_tokens(10, 0, SCFG)
    with pytest.raises(ServeError, match="not a multiple"):
        ServeConfig(block_size=8, prompt_buckets=(12,))


def test_launcher_sizing_matches_the_jax_launcher():
    from repro.launch.serve import build_serve_config as j_build
    from repro_torch.launch.serve import build_serve_config as t_build
    for args in [(256, 64, 16), (32, 8, 4), (5, 1, 1), (300, 20, 6)]:
        assert vars(t_build(*args)) == vars(j_build(*args)), args


# --------------------------------------------------------------------------- #
# B3's plain version against the Pallas kernel (interpret) and its oracle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("Kh,G,D", [(2, 2, 16), (1, 4, 64)])
def test_paged_attention_matches_jax_on_ragged_tables(Kh, G, D):
    B, NB, bs, MAXB = 4, 12, 4, 5
    rs = np.random.RandomState(D)
    lengths = np.asarray([1, 7, 20, 0], np.int32)  # incl. an empty row
    perm = rs.permutation(np.arange(1, NB))
    table = np.zeros((B, MAXB), np.int32)
    off = 0
    for b in range(B):
        nb = -(-int(lengths[b]) // bs)
        table[b, :nb] = perm[off:off + nb]
        off += nb
    q = rs.randn(B, Kh, G, D).astype(np.float32)
    pk = rs.randn(NB, bs, Kh, D).astype(np.float32)
    pv = rs.randn(NB, bs, Kh, D).astype(np.float32)
    args = (q, pk, pv, table, lengths)
    want = np.asarray(j_paged(*(jnp.asarray(a) for a in args)))
    oracle = np.asarray(j_paged_ref(*(jnp.asarray(a) for a in args)))
    targs = [torch.from_numpy(a) for a in args]
    before = TF.launches
    got = TF.paged_flash_attention(*targs).numpy()
    assert TF.launches == before          # CPU: the plain version, no launch
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(paged_attention_ref(*targs).numpy(), got)
    assert np.abs(got[3]).max() == 0.0    # L = 0 returns zeros
    zero = TF.paged_flash_attention(*targs[:4], torch.zeros(B, dtype=torch.int32))
    assert float(zero.abs().max()) == 0.0


def test_paged_attention_checks_its_operands():
    q = torch.zeros(2, 1, 2, 16)
    pool = torch.zeros(4, 4, 1, 16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="pools hold"):
        TF.paged_flash_attention(q, torch.zeros(4, 4, 2, 16),
                                 torch.zeros(4, 4, 2, 16), table, lengths)
    with pytest.raises(ValueError, match="table must be"):
        TF.paged_flash_attention(q, pool, pool, table[:1], lengths)
    with pytest.raises(ValueError, match="lengths must be"):
        TF.paged_flash_attention(q, pool, pool, table, lengths[:1])


# --------------------------------------------------------------------------- #
# the port's engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_churn(weights):
    params, _ = weights
    reqs = _requests(7, np.random.default_rng(3), cls=JRequest)
    return _run_churn(JEngine(JCFG, SCFG, params), reqs)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_engine_greedy_tokens_match_the_jax_engine(weights, jax_churn, impl):
    _, tparams = weights
    eng = Engine(TCFG, SCFG, tparams, attn_impl=impl)
    out = _run_churn(eng, _requests(7, np.random.default_rng(3)))
    assert out == jax_churn
    assert eng.alloc.used_blocks == 0
    assert eng.stats()["weights"] == "f32"


@pytest.fixture(scope="module")
def bf16_churn():
    """The churn scenario on gemma-2b reduced() in bfloat16: the JAX
    engine's tokens, and the port's weights."""
    import dataclasses
    cfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    params = JM.init(jax.random.key(0), cfg, 0)
    reqs = _requests(7, np.random.default_rng(3), cls=JRequest)
    out = _run_churn(JEngine(cfg, SCFG, params), reqs)
    return out, params_from_jax(jax.device_get(params))


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_engine_bf16_tokens_shared_with_the_jax_engine(bf16_churn, impl):
    """In bfloat16 the logits agree to about an ulp (tests/test_torch_lm.py
    checks them), so greedy tokens may part where two logits lie that
    close, and a request's later tokens follow its own history: the share
    of the JAX engine's tokens is reported (run with -s), held only to at
    least half, which a fault in a layer or the cache would break and
    near-ties do not (21 to 30 of 30 across the GELU's and B3's roundings).
    Each request still gets its full length, and every token is in the
    vocabulary."""
    import dataclasses
    want, tparams = bf16_churn
    eng = Engine(dataclasses.replace(TCFG, param_dtype="bfloat16"), SCFG,
                 tparams, attn_impl=impl)
    out = _run_churn(eng, _requests(7, np.random.default_rng(3)))
    assert eng.stats()["weights"] == "bf16"
    assert sorted(out) == sorted(want)
    assert all(len(out[r]) == len(want[r]) for r in want)
    assert all(0 <= t < TCFG.vocab_size for r in out for t in out[r])
    same = sum(a == b for r in want for a, b in zip(out[r], want[r]))
    total = sum(map(len, want.values()))
    print(f"bf16 {impl}: {same} of {total} greedy tokens equal to the JAX "
          f"engine's")
    assert 2 * same >= total


# --------------------------------------------------------------------------- #
# within the port: engine ≡ sequential
# --------------------------------------------------------------------------- #
def test_engine_matches_sequential_with_midstream_churn(weights, jax_churn):
    _, tparams = weights
    reqs = _requests(7, np.random.default_rng(3))
    seq = SequentialGenerator(TCFG, SCFG, tparams)
    for r in reqs:
        assert seq.generate(list(r.prompt), r.max_new, rid=r.rid) \
            == jax_churn[r.rid], f"rid={r.rid} P={len(r.prompt)}"


def test_engine_slot_recycling_under_pressure(weights):
    _, tparams = weights
    scfg = ServeConfig(max_batch=2, block_size=8, num_blocks=10,
                       max_blocks_per_seq=4, prompt_buckets=(8, 16))
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i,
                    prompt=[int(t) for t in rng.integers(
                        1, TCFG.vocab_size, int(rng.integers(3, 20)))],
                    max_new=4)
            for i in range(8)]                   # 8 requests through 2 slots
    eng = Engine(TCFG, scfg, tparams)
    out = eng.run(reqs)
    assert all(len(out[r.rid]) == 4 for r in reqs)
    assert eng.alloc.used_blocks == 0 and eng.peak_occupancy > 0
    seq = SequentialGenerator(TCFG, scfg, tparams)
    for r in reqs[:3]:
        assert seq.generate(list(r.prompt), r.max_new, rid=r.rid) \
            == out[r.rid]


def test_engine_stop_token_and_sampled_equivalence(weights):
    _, tparams = weights
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i,
                    prompt=[int(t) for t in rng.integers(1, TCFG.vocab_size,
                                                         12)],
                    max_new=6, temperature=0.8,
                    stop_token=int(rng.integers(1, TCFG.vocab_size)))
            for i in range(4)]
    # a stop token the first request does draw, so the stop path runs
    probe = Engine(TCFG, SCFG, tparams, seed=11).run(
        [Request(rid=0, prompt=reqs[0].prompt, max_new=6, temperature=0.8)])
    reqs[0].stop_token = probe[0][2]
    out = Engine(TCFG, SCFG, tparams, seed=11).run(reqs)
    seq = SequentialGenerator(TCFG, SCFG, tparams, seed=11)
    for r in reqs:
        ref = seq.generate(list(r.prompt), r.max_new, rid=r.rid,
                           temperature=r.temperature,
                           stop_token=r.stop_token)
        assert ref == out[r.rid]
        assert len(ref) <= r.max_new
        if len(ref) < r.max_new:
            assert ref[-1] == r.stop_token
    assert len(out[0]) <= 3 and out[0][-1] == reqs[0].stop_token
    # another seed draws other tokens
    assert Engine(TCFG, SCFG, tparams, seed=12).run(reqs) != out


def test_sample_token_is_keyed_by_seed_rid_and_index():
    row = torch.from_numpy(np.random.RandomState(0).randn(512)
                           .astype(np.float32))
    draws = {(s, r, i): sample_token(row, 1.0, r, i, s)
             for s in (0, 1) for r in (0, 1) for i in (0, 1)}
    assert len(set(draws.values())) > 2
    assert all(sample_token(row, 1.0, r, i, s) == t
               for (s, r, i), t in draws.items())
    assert sample_token(row, 0.0, 5, 5, 5) == int(row.argmax())
    assert len({draw_seed(0, r, i) for r in range(50)
                for i in range(50)}) == 2500


def test_engine_request_validation(weights):
    _, tparams = weights
    eng = Engine(TCFG, SCFG, tparams)
    with pytest.raises(ServeError, match="max_context"):
        eng.submit(Request(rid=0, prompt=list(range(1, 40)), max_new=60))
    with pytest.raises(ServeError, match="empty prompt"):
        eng.submit(Request(rid=1, prompt=[], max_new=4))
    eng.submit(Request(rid=2, prompt=[5, 6, 7], max_new=2))
    with pytest.raises(ServeError, match="duplicate"):
        eng.submit(Request(rid=2, prompt=[5], max_new=1))
    with pytest.raises(ServeError, match="gather|kernel"):
        Engine(TCFG, SCFG, tparams, attn_impl="pallas")
    with pytest.raises(ServeError, match="slice 7"):
        Engine(TCFG, SCFG, tparams, compression=object())


def test_sliding_window_and_unported_blocks_are_refused(weights):
    import dataclasses
    _, tparams = weights
    with pytest.raises(ServeError, match="sliding-window"):
        Engine(dataclasses.replace(TCFG, attention_window=32), SCFG, tparams)
    with pytest.raises(NotImplementedError, match="slice 6"):
        Engine(dataclasses.replace(TCFG, layer_pattern=("ssd",)), SCFG,
               tparams)
