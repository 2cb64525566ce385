"""Port parity of the encoder-decoder path (whisper-tiny) against `repro`
on the CPU: `model.encode`, cross-attention, the learned positions, the
encoder inputs of `data.lm_batch_iterator`, prefill + decode with the
encoder output in the cache, the trees, and the trainer's CLI. whisper is
`reduced()` (2 + 2 layers, d_model 256, 4 heads, layernorm, biases, tied
embeddings, 64 encoder frames), the JAX weights carried across by
`convert.params_from_jax` after a numpy-seeded nudge, the inputs numpy
draws on both sides.

Tolerance: float32 outputs within 1e-5 of the reference's largest |value|
(both sides in float32, sums in other orders); the encoder inputs on
JAX's draws bit for bit.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.data import synthetic as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic as TD
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import Engine, ServeConfig, ServeError
from torch_ranks import one_thread  # noqa: F401 (autouse)

JCFG = jcfgs.get("whisper-tiny").reduced()
TCFG = tcfgs.get("whisper-tiny").reduced()
MAX_SEQ = 32


def _f32(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    jnp.asarray(x).astype(jnp.float32), np.float32)


def _close(got, want, rel=1e-5, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def weights():
    """JAX whisper reduced() weights (a 32-position table), moved off
    their init by numpy draws, and their port copy."""
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda w: w + 0.02 * rs.randn(*w.shape).astype(np.float32),
        JM.init(jax.random.key(0), JCFG, MAX_SEQ))
    return params, params_from_jax(jax.device_get(params))


def _enc(batch=2, seed=1):
    return (0.1 * np.random.RandomState(seed).randn(
        batch, JCFG.encdec.enc_seq, JCFG.d_model)).astype(np.float32)


def test_init_and_cache_trees_match_jax():
    """init (the encoder, the position tables, cross-attention in every
    decoder block) and init_cache (with "enc_out") give the reference's
    trees: paths, shapes, dtypes; an absolute-position model refuses
    max_seq 0."""
    cfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, param_dtype="bfloat16")
    for j, t in ((JM.init(jax.random.key(0), cfg, MAX_SEQ),
                  TM.init(tcfg, generator=torch.Generator().manual_seed(0),
                          max_seq=MAX_SEQ)),
                 (JM.init_cache(cfg, 2, 16), TM.init_cache(tcfg, 2, 16))):
        jp, jl = T.flatten(jax.device_get(j))
        tp, tl = T.flatten(t)
        assert [T.keystr(p) for p in tp] == [T.keystr(p) for p in jp]
        for path, a, b in zip(jp, jl, tl):
            if a is None:           # an unscanned model's "scan"
                assert b is None
                continue
            assert tuple(b.shape) == np.shape(a), T.keystr(path)
            assert str(b.dtype)[6:] == str(np.asarray(a).dtype)
    tp = TM.init(TCFG, max_seq=MAX_SEQ)
    assert tp["pos"].shape == (MAX_SEQ, TCFG.d_model)
    assert tp["enc"]["pos"].shape == (JCFG.encdec.enc_seq, TCFG.d_model)
    assert all("cross" in b and "cross_norm" in b for b in tp["tail"])
    with pytest.raises(ValueError, match="max_seq"):
        TM.init(TCFG)


def test_encode_matches_jax(weights):
    """The encoder over 64 frames: learned positions, non-causal
    attention blocks, the final layernorm."""
    params, tparams = weights
    e = _enc()
    _close(TM.encode(tparams, TCFG, torch.from_numpy(e)),
           JM.encode(params, JCFG, jnp.asarray(e)))


def test_cross_attention_matches_jax(weights):
    """A decoder block's cross-attention: K/V projected from the encoder
    output with their biases, every query against every frame."""
    params, tparams = weights
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, JCFG.d_model).astype(np.float32)
    enc = rs.randn(2, 64, JCFG.d_model).astype(np.float32)
    jp, tp = params["tail"][0]["cross"], tparams["tail"][0]["cross"]
    te = torch.from_numpy(enc)
    Kh, hd = TCFG.num_kv_heads, TCFG.head_dim
    ck = TL._split_heads(TL.linear(tp["k"], te), Kh, hd)
    cv = TL._split_heads(TL.linear(tp["v"], te), Kh, hd)
    jk, jv = JM._cross_kvs(params, JCFG, jnp.asarray(enc))(jp)
    _close(ck, jk, what="k")
    _close(cv, jv, what="v")
    pos = np.arange(5)
    got, cache = TL.attn_apply(tp, torch.from_numpy(x), TCFG,
                               torch.from_numpy(pos), cross_kv=te)
    want, _ = JL.attn_apply(jp, jnp.asarray(x), JCFG, jnp.asarray(pos),
                            cross_kv=(jk, jv))
    assert cache is None
    _close(got, want)
    # the block: self-attention, cross-attention, the MLP
    bj = JM.block_apply(params["tail"][0], JCFG, "attn", jnp.asarray(x),
                        jnp.asarray(pos), cross_kv=jnp.asarray(enc))[0]
    bt = TM.block_apply(tparams["tail"][0], TCFG, "attn", torch.from_numpy(x),
                        torch.from_numpy(pos), cross_kv=torch.from_numpy(enc))
    _close(bt[0], bj, what="block")


@pytest.mark.parametrize("positions", [np.arange(6), np.array([9])])
def test_learned_positions_in_the_embedding(weights, positions):
    """The token embedding plus the learned position rows, over a
    prefill's positions and a decode position."""
    params, tparams = weights
    toks = np.random.RandomState(3).randint(0, 512, (2, len(positions)))
    _close(TM._embed_tokens(tparams, TCFG, torch.from_numpy(toks),
                            torch.from_numpy(positions)),
           JM._embed_tokens(params, JCFG, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(positions)))


def test_lm_batch_iterator_enc_embeds_on_jax_draws():
    """`enc_embeds` on the standard normal draws the JAX iterator makes
    for a batch gives its batch's encoder inputs bit for bit; the port's
    iterator draws them after the tokens, (batch,) + enc_shape, float32."""
    enc_shape = (64, 32)
    jb = next(JD.lm_batch_iterator(5, 2, 16, 512, enc_shape))
    normal = jax.random.normal(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(5), 0), 1), (2,) + enc_shape)
    got = TD.enc_embeds(torch.tensor(np.asarray(normal)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jb["enc_embeds"]))
    b = next(TD.lm_batch_iterator(2, 16, 512, enc_shape=enc_shape,
                                  generator=torch.Generator().manual_seed(3)))
    plain = next(TD.lm_batch_iterator(
        2, 16, 512, generator=torch.Generator().manual_seed(3)))
    assert b["enc_embeds"].shape == (2,) + enc_shape
    assert b["enc_embeds"].dtype == torch.float32
    assert torch.equal(b["tokens"], plain["tokens"])
    assert 0.05 < b["enc_embeds"].std().item() < 0.2


def test_prefill_and_decode_match_jax(weights):
    """`model.prefill(enc_embeds=)` over 12 tokens, then 3 teacher-forced
    decode steps against the cached encoder output: logits and caches
    equal the reference's, and the decode logits equal one forward over
    the 15 tokens."""
    params, tparams = weights
    e = _enc(seed=4)
    toks = np.random.RandomState(5).randint(1, 512, (2, 15))
    lj, cj = jax.jit(lambda p, t, e: JM.prefill(p, JCFG, t, e, max_len=16))(
        params, jnp.asarray(toks[:, :12], jnp.int32), jnp.asarray(e))
    lt, ct = TM.prefill(tparams, TCFG, torch.from_numpy(toks[:, :12]),
                        torch.from_numpy(e), max_len=16)
    _close(lt, lj, what="prefill")
    step = jax.jit(lambda p, t, c: JM.decode_step(p, JCFG, t, c))
    got = [lt]
    for t in range(12, 15):
        lj, cj = step(params, jnp.asarray(toks[:, t:t + 1], jnp.int32), cj)
        lt, ct = TM.decode_step(tparams, TCFG, torch.from_numpy(
            toks[:, t:t + 1]), ct)
        _close(lt, lj, what=f"logits {t}")
        got.append(lt)
    paths, jl = T.flatten(jax.device_get(cj))
    tl = T.flatten_up_to(paths, ct)
    assert "['enc_out']" in [T.keystr(p) for p in paths]
    for path, a, b in zip(paths, jl, tl):
        if a is None:               # an unscanned model's "scan"
            assert b is None
            continue
        _close(b, a, what=T.keystr(path))
    enc = TM.encode(tparams, TCFG, torch.from_numpy(e))
    hidden, _, _ = TM.forward(tparams, TCFG, torch.from_numpy(toks),
                              torch.arange(15), enc_out=enc)
    _close(torch.stack(got, 1), TM.logits_fn(tparams, TCFG, hidden[:, 11:]),
           what="decode vs forward")


def test_decode_past_the_position_table_fails(weights):
    """Learned positions cover max_seq tokens. The JAX package's decode
    step past them reads `jnp.take`'s fill value (NaN rows) and returns
    non-finite logits; the port's refuses the step with a ValueError,
    before it reads any row."""
    jparams, tparams = weights
    toks = np.ones((1, MAX_SEQ), np.int32)
    _, cj = jax.jit(lambda p, t, e: JM.prefill(p, JCFG, t, e,
                                               max_len=MAX_SEQ + 1))(
        jparams, jnp.asarray(toks), jnp.asarray(_enc(1)))
    lj, _ = jax.jit(lambda p, t, c: JM.decode_step(p, JCFG, t, c))(
        jparams, jnp.asarray(toks[:, :1]), cj)
    assert not np.isfinite(np.asarray(lj)).any()
    _, caches = TM.prefill(tparams, TCFG, torch.from_numpy(toks).long(),
                           torch.from_numpy(_enc(1)), max_len=MAX_SEQ + 1)
    with pytest.raises(ValueError, match="past the learned position table"):
        TM.decode_step(tparams, TCFG, torch.ones((1, 1), dtype=torch.long),
                       caches)


def test_paged_engine_refuses_whisper_and_recurrentgemma():
    """The JAX engine's reasons: cross-attention caches are not paged, a
    windowed model keeps its rolling dense cache."""
    scfg = ServeConfig(max_batch=2, block_size=8, num_blocks=8,
                       max_blocks_per_seq=2, prompt_buckets=(8,))
    with pytest.raises(ServeError, match="encoder-decoder"):
        Engine(TCFG, scfg, {"embed": torch.zeros(1)})
    with pytest.raises(ServeError, match="sliding-window"):
        Engine(tcfgs.get("recurrentgemma-2b").reduced(), scfg,
               {"embed": torch.zeros(1)})


def test_cli_trains_whisper_with_the_jax_clis_wire_numbers():
    """`--device cpu --smoke --seq 16`, 3 steps, the batches carrying
    (64, 256) encoder frames a row: finite rows whose wire_mb_step,
    cum_wire_mb and comm_ratio equal the JAX CLI's."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    flags = ["--arch", "whisper-tiny", "--smoke", "--seq", "16", "--steps",
             "3", "--optimizer", "omd", "--compressor", "qsgd8_block1024",
             "--comm-plan", "uniform", "--log-every", "1"]

    def rows(out):
        return [json.loads(x) for x in out.splitlines() if x.startswith("{")]

    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = ttrain.main(flags + ["--device", "cpu"])
    got = rows(buf.getvalue())
    assert got == hist and len(got) == 3
    assert all(np.isfinite(r["loss"]) and r["step_s"] > 0 for r in got)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jtrain.main(flags)
    want = rows(buf.getvalue())
    assert len(want) == 3
    for a, b in zip(got, want):
        for k in ("wire_mb_step", "cum_wire_mb", "comm_ratio"):
            assert a[k] == b[k], k
