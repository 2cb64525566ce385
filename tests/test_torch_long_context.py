"""Port parity: long-prompt prefill (`attention_chunked`, taken above 2048
tokens) and the rolling sliding-window cache (gemma-2b-swa) of
`repro_torch.models` against `repro.models`, on the CPU, at small widths:
gemma-2b-swa `reduced()` (2 layers, d 256, 4 heads, 1 KV head, vocab 512,
float32) with its window shrunk by `dataclasses.replace` in both
packages, the JAX weights carried across by `convert.params_from_jax`.

Tolerance: atol/rtol 1e-5 (float32 on both sides, sums in other orders).
The rolling cache's layout, which position each slot holds, is held
exactly: the port's prefill cache is a gather of the prompt's own K/V."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_ranks import one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
WIN = 8
JCFG = dataclasses.replace(jcfgs.get("gemma-2b-swa").reduced(),
                           attention_window=WIN)
TCFG = dataclasses.replace(tcfgs.get("gemma-2b-swa").reduced(),
                           attention_window=WIN)


def _close(actual, desired, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _trees_close(torch_tree, jax_tree, **tol):
    paths, jl = T.flatten(jax.device_get(jax_tree))
    tl = T.flatten_up_to(paths, torch_tree)
    assert len(tl) == len(jl)
    for path, a, b in zip(paths, jl, tl):
        assert tuple(b.shape) == np.shape(a), T.keystr(path)
        _close(b.numpy(), a, **tol)


@pytest.fixture(scope="module")
def weights():
    """JAX gemma-2b-swa reduced() weights, moved off their tiny init scale,
    and their port copy."""
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda w: w + 0.02 * rs.randn(*w.shape).astype(np.float32),
        JM.init(jax.random.key(0), JCFG, 0))
    return params, params_from_jax(jax.device_get(params))


def test_swa_config_matches_the_jax_config():
    full_j, full_t = jcfgs.get("gemma-2b-swa"), tcfgs.get("gemma-2b-swa")
    red_j, red_t = full_j.reduced(), full_t.reduced()
    for f in full_t.__dataclass_fields__:
        assert getattr(full_t, f) == getattr(full_j, f), f
        assert getattr(red_t, f) == getattr(red_j, f), f
    assert full_t.attention_window == 4096 and red_t.attention_window == 32
    assert full_t.param_count() == tcfgs.get("gemma-2b").param_count()


# --------------------------------------------------------------------------- #
# attention_chunked
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S,q_chunk", [(64, 16), (48, 8)])
@pytest.mark.parametrize("window", [0, 5, 16, 24])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,K", [(4, 2), (4, 1)])
def test_attention_chunked_matches_jax(S, q_chunk, window, causal, H, K):
    rs = np.random.RandomState(S + window + H * K)
    q = rs.randn(2, S, H, 16).astype(np.float32)
    k = rs.randn(2, S, K, 16).astype(np.float32)
    v = rs.randn(2, S, K, 16).astype(np.float32)
    want = JL.attention_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                window=window, causal=causal, q_chunk=q_chunk)
    got = TL.attention_chunked(_t(q), _t(k), _t(v), window=window,
                               causal=causal, q_chunk=q_chunk)
    assert tuple(got.shape) == want.shape == (2, S, H * 16)
    _close(got, want)
    if causal:   # the bands cover every key the window lets in
        pos = torch.arange(S)
        _close(got, TL.attention_dense(_t(q), _t(k), _t(v), pos, pos,
                                       window=window), rtol=1e-4, atol=1e-4)


def test_attention_chunked_needs_whole_chunks():
    x = torch.zeros(1, 24, 2, 8)
    with pytest.raises(ValueError, match="q_chunk"):
        TL.attention_chunked(x, x, x, q_chunk=16)


@pytest.mark.parametrize("window", [0, 512])
def test_attn_apply_prefill_4096_takes_the_chunked_path(weights, window):
    """attn_apply at S = 4096 (> 2048): four chunks of 1024 queries, the
    output and the returned cache against the JAX layer's."""
    params, tparams = weights
    jcfg = dataclasses.replace(JCFG, attention_window=window)
    tcfg = dataclasses.replace(TCFG, attention_window=window)
    p = jax.tree.map(lambda a: a[0], params["scan"]["b0"]["attn"])
    tp = T.tree_map(lambda a: a[0], tparams["scan"]["b0"]["attn"])
    S = 4096
    x = np.random.RandomState(5).randn(1, S, JCFG.d_model).astype(np.float32)
    calls = []
    real = TL.attention_dense

    def spy(q, *a, **kw):
        calls.append(q.shape[1])
        return real(q, *a, **kw)

    out_j, cache_j = JL.attn_apply(p, jnp.asarray(x), jcfg, jnp.arange(S),
                                   fill_cache=True)
    TL.attention_dense = spy
    try:
        out_t, cache_t = TL.attn_apply(tp, _t(x), tcfg, torch.arange(S),
                                       fill_cache=True)
    finally:
        TL.attention_dense = real
    assert calls == [1024] * 4
    _close(out_t, out_j, rtol=1e-4, atol=1e-5)
    _trees_close(cache_t, cache_j)
    assert cache_t["k"].shape[1] == (window or S)


# --------------------------------------------------------------------------- #
# the rolling sliding-window cache
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [5, WIN, 13])
def test_window_prefill_cache_layout(weights, S):
    """fill_cache with a window: below the window the prompt's K/V padded
    to `window` slots, from the window on slot i holds position
    S - win + ((i - S) mod win); equal to JAX's cache, and a gather of the
    port's own K/V exactly."""
    params, tparams = weights
    p = jax.tree.map(lambda a: a[0], params["scan"]["b0"]["attn"])
    tp = T.tree_map(lambda a: a[0], tparams["scan"]["b0"]["attn"])
    x = np.random.RandomState(S).randn(2, S, JCFG.d_model).astype(np.float32)
    out_j, cache_j = JL.attn_apply(p, jnp.asarray(x), JCFG, jnp.arange(S),
                                   fill_cache=True)
    out_t, cache_t = TL.attn_apply(tp, _t(x), TCFG, torch.arange(S),
                                   fill_cache=True)
    _close(out_t, out_j)
    _trees_close(cache_t, cache_j)
    assert cache_t["k"].shape[1] == WIN and int(cache_t["pos"]) == S
    # the layout, exactly: the unrolled K/V of the same call
    _, full = TL.attn_apply(tp, _t(x), dataclasses.replace(TCFG,
                                                          attention_window=0),
                            torch.arange(S), fill_cache=True)
    for i in range(WIN):
        p_i = i if S < WIN else S - WIN + (i - S) % WIN
        for name in ("k", "v"):
            if p_i < S:
                assert torch.equal(cache_t[name][:, i], full[name][:, p_i])
            else:
                assert not cache_t[name][:, i].any()


def test_window_cache_init_and_prefill_shapes(weights):
    """A windowed dense cache holds min(seq, window) slots, and prefill
    pads no windowed cache to max_len (JAX's model.prefill)."""
    params, tparams = weights
    for seq in (5, WIN, 40):
        _trees_close(TM.init_cache(TCFG, 2, seq),
                     jax.device_get(JM.init_cache(JCFG, 2, seq)))
        assert TM.init_cache(TCFG, 2, seq)["scan"]["b0"]["k"].shape[2] == \
            min(seq, WIN)
    prompt = np.arange(1, 12)[None]
    _, c_j = JM.prefill(params, JCFG, jnp.asarray(prompt, jnp.int32),
                        max_len=40)
    _, c_t = TM.prefill(tparams, TCFG, _t(prompt).long(), max_len=40)
    _trees_close(c_t, c_j)
    assert c_t["scan"]["b0"]["k"].shape[2] == WIN


@pytest.mark.parametrize("P", [5, 13])
def test_rolling_decode_matches_jax_and_a_full_prefill(weights, P):
    """gemma-2b-swa reduced() with an 8-token window: prefill P tokens
    (below and above the window), then 12 teacher-forced decode steps that
    wrap the window. Each step's logits equal JAX's decode and the last
    logits of a prefill of the whole sequence so far; the caches equal
    JAX's at the end."""
    params, tparams = weights
    rs = np.random.RandomState(P)
    seq = rs.randint(1, JCFG.vocab_size, (2, P + 12))
    lg_j, c_j = JM.prefill(params, JCFG, jnp.asarray(seq[:, :P], jnp.int32))
    lg_t, c_t = TM.prefill(tparams, TCFG, _t(seq[:, :P]).long())
    _close(lg_t, lg_j)
    _trees_close(c_t, c_j)
    for t in range(P, P + 12):
        tok = seq[:, t:t + 1]
        lg_j, c_j = JM.decode_step(params, JCFG, jnp.asarray(tok, jnp.int32),
                                   c_j)
        lg_t, c_t = TM.decode_step(tparams, TCFG, _t(tok).long(), c_t)
        _close(lg_t, lg_j)
        full, _ = TM.prefill(tparams, TCFG, _t(seq[:, :t + 1]).long())
        _close(lg_t, full, rtol=1e-4, atol=1e-4)
    _trees_close(c_t, c_j)
    assert int(c_t["scan"]["b0"]["pos"][0]) == P + 12


def test_rolling_decode_after_a_chunked_prefill():
    """A window above the chunk size at a prefill above 2048 tokens: the
    chunked prefill's rolling cache, then decode steps that wrap it, against
    JAX (one layer, narrow widths)."""
    jcfg = dataclasses.replace(JCFG, attention_window=1536, num_layers=1,
                               d_model=64, num_heads=2, head_dim=32,
                               d_ff=128, vocab_size=128)
    tcfg = dataclasses.replace(TCFG, attention_window=1536, num_layers=1,
                               d_model=64, num_heads=2, head_dim=32,
                               d_ff=128, vocab_size=128)
    rs = np.random.RandomState(3)
    params = jax.tree.map(
        lambda w: w + 0.02 * rs.randn(*w.shape).astype(np.float32),
        JM.init(jax.random.key(1), jcfg, 0))
    tparams = params_from_jax(jax.device_get(params))
    S = 3072
    seq = rs.randint(1, jcfg.vocab_size, (1, S + 3))
    lg_j, c_j = JM.prefill(params, jcfg, jnp.asarray(seq[:, :S], jnp.int32))
    lg_t, c_t = TM.prefill(tparams, tcfg, _t(seq[:, :S]).long())
    _close(lg_t, lg_j, rtol=1e-4, atol=1e-5)
    _trees_close(c_t, c_j, rtol=1e-4, atol=1e-5)
    for t in range(S, S + 3):
        tok = seq[:, t:t + 1]
        lg_j, c_j = JM.decode_step(params, jcfg, jnp.asarray(tok, jnp.int32),
                                   c_j)
        lg_t, c_t = TM.decode_step(tparams, tcfg, _t(tok).long(), c_t)
        _close(lg_t, lg_j, rtol=1e-4, atol=1e-5)
    assert c_t["scan"]["b0"]["k"].shape[2] == 1536
