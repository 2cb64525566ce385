"""Port parity: the LM layers and the dense decoder of `repro_torch.models`
against `repro.models`, on gemma-2b `reduced()` (2 layers, d 256, 4 heads,
1 KV head, head_dim 64, vocab 512, float32) with the JAX weights carried
across by `convert.params_from_jax`, and the same numpy inputs on both
sides.

Tolerance: atol/rtol 1e-5. Both sides compute in float32 on the CPU; the
matmuls and reductions of PyTorch and XLA sum in other orders, a few ulps
per output, well inside 1e-5 at these widths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import init_paged_cache as j_init_paged_cache
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_ranks import one_thread  # noqa: F401 (autouse)

JCFG = jcfgs.get("gemma-2b").reduced()
TCFG = tcfgs.get("gemma-2b").reduced()
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(actual, desired, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _trees_close(torch_tree, jax_tree):
    paths, jl = T.flatten(jax.device_get(jax_tree))
    tl = T.flatten_up_to(paths, torch_tree)
    assert len(tl) == len(jl)
    for path, a, b in zip(paths, jl, tl):
        assert tuple(b.shape) == np.shape(a), T.keystr(path)
        _close(b.numpy(), a)


@pytest.fixture(scope="module")
def weights():
    """JAX gemma-2b reduced() weights, moved off their tiny init scale so
    that every layer matters, and their port copy."""
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda w: w + 0.02 * rs.randn(*w.shape).astype(np.float32),
        JM.init(jax.random.key(0), JCFG, 0))
    return params, params_from_jax(jax.device_get(params))


def _field(cfg, f):
    """A config field; a sub-config (MoEConfig, ...) as a dict, since
    each package has its own class."""
    import dataclasses
    v = getattr(cfg, f)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_config_matches_the_jax_config():
    """Every LM arch of the port, full and reduced(), field for field."""
    for arch in ("gemma-2b", "gemma-2b-swa", "starcoder2-7b", "yi-34b",
                 "chameleon-34b", "command-r-plus-104b", "qwen3-moe-30b-a3b",
                 "arctic-480b", "mamba2-1.3b", "recurrentgemma-2b",
                 "whisper-tiny"):
        full_j, full_t = jcfgs.get(arch), tcfgs.get(arch)
        for f in full_t.__dataclass_fields__:
            assert _field(full_t, f) == _field(full_j, f), (arch, f)
            assert (_field(full_t.reduced(), f)
                    == _field(full_j.reduced(), f)), (arch, f)
        assert full_t.param_count() == full_j.param_count(), arch
        assert full_t.positional == full_j.positional, arch
        assert full_t.is_encdec == full_j.is_encdec, arch
    assert tcfgs.get("gemma-2b").param_count() == 3_030_460_416
    assert tcfgs.get("mamba2-1.3b").param_count() == 1_446_812_672
    assert tcfgs.get("whisper-tiny").positional == "learned"


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 32).astype(np.float32) * 3
    p = {"scale": rs.randn(32).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rs.randn(32).astype(np.float32)
    want = JL.apply_norm(kind, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm(kind, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want)


@pytest.mark.parametrize("pos_shape", [(7,), (3, 1)])
def test_rope(pos_shape):
    rs = np.random.RandomState(2)
    x = rs.randn(3, pos_shape[-1], 4, 64).astype(np.float32)
    pos = rs.randint(0, 500, size=pos_shape).astype(np.int32)
    _close(TL.rope(_t(x), _t(pos), 10_000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("activation", ["geglu", "silu", "gelu"])
def test_mlp(activation):
    p = JL.mlp_init(jax.random.key(3), 32, 64, activation, True, jnp.float32)
    p = jax.tree.map(lambda w: w + 0.1, p)  # biases away from zero
    x = np.random.RandomState(3).randn(2, 5, 32).astype(np.float32)
    _close(TL.mlp(params_from_jax(jax.device_get(p)), _t(x), activation),
           JL.mlp(p, jnp.asarray(x), activation))


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), per element."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _assert_bf16_close(got, want, max_frac=0.01):
    """At most one bfloat16 ulp of the reference per element, and at most
    `max_frac` of the elements differing at all."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    d = np.abs(got - want)
    assert (d <= _bf16_ulp(want)).all(), (d / _bf16_ulp(want)).max()
    assert (d > 0).mean() <= max_frac, (d > 0).mean()


def test_gelu_bfloat16_follows_the_reference():
    """The tanh GELU evaluated op by op in bfloat16, as jax.nn.gelu
    (approximate=True) is: 65,536 draws from N(0, 9). (Rounding once from
    float32, as F.gelu does, differs in about 43 % of them.)"""
    x = (3 * np.random.RandomState(11).randn(65536)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jax.nn.gelu(xj, approximate=True).astype(jnp.float32)
    got = TL._gelu_tanh(_t(np.asarray(xj.astype(jnp.float32)))
                        .to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("seed,sigma", [(11, 4), (0, 3)])
def test_silu_bfloat16_follows_the_reference(seed, sigma):
    """SiLU evaluated op by op in bfloat16, as jax.nn.silu is on the CPU
    backend (x * (1 / (1 + exp(-x))), each op rounded to bfloat16): equal
    to the reference on all 65,536 draws from N(0, sigma²) (seed 0, sigma
    3: tests/bf16_token_share.py's draws). (F.silu, which rounds once
    from float32, differs in about 37 % of them.)"""
    x = (sigma * np.random.RandomState(seed).randn(65536)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.nn.silu(xj).astype(jnp.float32))
    got = TL._silu(_t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # float32 to float32 rounding
    _close(TL._silu(_t(x)), jax.nn.silu(jnp.asarray(x)), rtol=1e-6,
           atol=1e-7)


@pytest.mark.parametrize("activation", ["geglu", "gelu", "silu"])
def test_mlp_bfloat16(activation):
    """bfloat16 weights and inputs: the linears and the GELU or SiLU
    rounded where the reference rounds them."""
    p = JL.mlp_init(jax.random.key(3), 32, 64, activation, True,
                    jnp.bfloat16)
    p = jax.tree.map(lambda w: w + 0.1, p)
    xj = jnp.asarray(np.random.RandomState(3).randn(2, 5, 32), jnp.bfloat16)
    got = TL.mlp(params_from_jax(jax.device_get(p)),
                 _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16),
                 activation)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, JL.mlp(p, xj, activation).astype(jnp.float32))


def test_bfloat16_prefill_and_decode_logits():
    """gemma-2b reduced() in bfloat16: prefill logits and one
    teacher-forced decode step's logits within two bfloat16 ulps of the
    reference's largest |logit|. (The two frameworks round the norms,
    RoPE, attention and the bf16 matmuls' sums at other places, so single
    logits differ by about an ulp.)"""
    import dataclasses
    cfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, param_dtype="bfloat16")
    rs = np.random.RandomState(12)
    params = jax.tree.map(
        lambda w: (w.astype(jnp.float32) + 0.02 * rs.randn(*w.shape)
                   .astype(np.float32)).astype(w.dtype),
        JM.init(jax.random.key(0), cfg, 0))
    tparams = params_from_jax(jax.device_get(params))
    prompt = rs.randint(1, cfg.vocab_size, (2, 12))
    lg_j, c_j = JM.prefill(params, cfg, jnp.asarray(prompt, jnp.int32),
                           max_len=16)
    lg_t, c_t = TM.prefill(tparams, tcfg, _t(prompt).long(), max_len=16)
    tok = rs.randint(1, cfg.vocab_size, (2, 1))     # teacher-forced
    dj, _ = JM.decode_step(params, cfg, jnp.asarray(tok, jnp.int32), c_j)
    dt, _ = TM.decode_step(tparams, tcfg, _t(tok).long(), c_t)
    for got, want in ((lg_t, lg_j), (dt, dj)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        tol = 2 * _bf16_ulp(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("window,causal", [(0, True), (3, True), (0, False)])
def test_attention_dense(window, causal):
    rs = np.random.RandomState(4)
    q = rs.randn(2, 6, 4, 16).astype(np.float32)
    k = rs.randn(2, 6, 2, 16).astype(np.float32)
    v = rs.randn(2, 6, 2, 16).astype(np.float32)
    pos = np.arange(6)
    want = JL.attention_dense(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                              window=window, causal=causal)
    got = TL.attention_dense(*(_t(a) for a in (q, k, v, pos, pos)),
                             window=window, causal=causal)
    _close(got, want)


def test_attn_apply_prefill_and_dense_decode(weights):
    params, tparams = weights
    p = jax.tree.map(lambda a: a[0], params["scan"]["b0"]["attn"])
    tp = T.tree_map(lambda a: a[0], tparams["scan"]["b0"]["attn"])
    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, JCFG.d_model).astype(np.float32)
    out_j, cache_j = JL.attn_apply(p, jnp.asarray(x), JCFG, jnp.arange(8),
                                   fill_cache=True)
    out_t, cache_t = TL.attn_apply(tp, _t(x), TCFG, torch.arange(8),
                                   fill_cache=True)
    _close(out_t, out_j)
    _trees_close(cache_t, cache_j)
    # decode one token against a dense cache with room for it
    cache_j = {"k": jnp.pad(cache_j["k"], ((0, 0), (0, 4), (0, 0), (0, 0))),
               "v": jnp.pad(cache_j["v"], ((0, 0), (0, 4), (0, 0), (0, 0))),
               "pos": cache_j["pos"]}
    cache_t = params_from_jax(jax.device_get(cache_j))
    x1 = rs.randn(2, 1, JCFG.d_model).astype(np.float32)
    out_j, new_j = JL.attn_apply(p, jnp.asarray(x1), JCFG,
                                 jnp.asarray([8], jnp.int32), cache=cache_j)
    out_t, new_t = TL.attn_apply(tp, _t(x1), TCFG,
                                 torch.tensor([8], dtype=torch.int32),
                                 cache=cache_t)
    _close(out_t, out_j)
    _trees_close(new_t, new_j)


def _paged_cache(seed):
    """A JAX paged cache for gemma reduced() with random pools and ragged
    tables, plus per-row lengths; row 2 is an inactive slot, parked on the
    scratch block 0, which it writes and reads."""
    scfg = JServeConfig(max_batch=3, block_size=8, num_blocks=16,
                        max_blocks_per_seq=4, prompt_buckets=(8, 16))
    cache = j_init_paged_cache(JCFG, scfg)
    rs = np.random.RandomState(seed)
    lengths = np.asarray([5, 19, 0], np.int32)
    perm = rs.permutation(np.arange(1, scfg.num_blocks))
    table = np.zeros((3, 4), np.int32)
    table[0, :1], table[1, :3] = perm[:1], perm[1:4]
    leaf = cache["scan"]["b0"]
    n = leaf["k"].shape[0]
    cache["scan"]["b0"] = {
        "k": jnp.asarray(rs.randn(*leaf["k"].shape).astype(np.float32)),
        "v": jnp.asarray(rs.randn(*leaf["v"].shape).astype(np.float32)),
        "table": jnp.asarray(np.broadcast_to(table, (n, 3, 4)).copy())}
    return cache, lengths


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_decode_step_paged_logits_and_pools(weights, impl):
    """The port's paged decode, with either attention impl (the kernel's
    plain version on the CPU), against the JAX gather impl."""
    params, tparams = weights
    cache_j, lengths = _paged_cache(6)
    cache_t = params_from_jax(jax.device_get(cache_j))
    tokens = np.asarray([[3], [77], [500]], np.int32)
    lg_j, new_j = JM.decode_step_paged(params, JCFG, jnp.asarray(tokens),
                                       cache_j, jnp.asarray(lengths))
    prev = TL.set_paged_attn_impl(impl)
    try:
        lg_t, new_t = TM.decode_step_paged(tparams, TCFG,
                                           _t(tokens).long(), cache_t,
                                           _t(lengths))
    finally:
        TL.set_paged_attn_impl(prev)
    _close(lg_t, lg_j)
    _trees_close(new_t, new_j)


def test_prefill_then_decode_matches(weights):
    """prefill (floor bucket, padded to max_len) then decode_step, logits
    at every step and the caches at the end."""
    params, tparams = weights
    prompt = np.random.RandomState(7).randint(1, JCFG.vocab_size, (2, 12))
    lg_j, c_j = JM.prefill(params, JCFG, jnp.asarray(prompt, jnp.int32),
                           max_len=20)
    lg_t, c_t = TM.prefill(tparams, TCFG, _t(prompt).long(), max_len=20)
    _close(lg_t, lg_j)
    _trees_close(c_t, c_j)
    assert c_t["tail"] == [] and tuple(c_t["scan"]["b0"]["pos"].shape) == (2,)
    tok = np.argmax(np.asarray(lg_j), -1)[:, None]
    for _ in range(3):
        lg_j, c_j = JM.decode_step(params, JCFG,
                                   jnp.asarray(tok, jnp.int32), c_j)
        lg_t, c_t = TM.decode_step(tparams, TCFG, _t(tok).long(), c_t)
        _close(lg_t, lg_j)
        tok = np.argmax(np.asarray(lg_j), -1)[:, None]
    _trees_close(c_t, c_j)
    assert int(c_t["scan"]["b0"]["pos"][0]) == 15


def test_init_cache_and_init_shapes_match():
    jc = jax.device_get(JM.init_cache(JCFG, 2, 16))
    tc = TM.init_cache(TCFG, 2, 16)
    _trees_close(tc, jc)
    jp = jax.eval_shape(lambda: JM.init(jax.random.key(0), JCFG, 0))
    tp = TM.init(TCFG, generator=torch.Generator().manual_seed(0))
    paths, jl = T.flatten(jp)
    for path, a, b in zip(paths, jl, T.flatten_up_to(paths, tp)):
        assert tuple(b.shape) == a.shape and str(b.dtype)[6:] == str(a.dtype), \
            T.keystr(path)
    assert sum(b.numel() for b in T.leaves(tp)) == TCFG.param_count()


def test_bfloat16_params_round_trip_bit_exact():
    """JAX gemma-2b reduced() in bfloat16 crosses to the port and back bit
    for bit (numpy holds bf16 as ml_dtypes.bfloat16, torch cannot read it
    directly)."""
    import dataclasses
    cfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    params = jax.device_get(JM.init(jax.random.key(1), cfg, 0))
    tp = params_from_jax(params)
    assert all(t.dtype == torch.bfloat16 for t in T.leaves(tp))
    back = params_to_jax(tp)
    paths, jl = T.flatten(params)
    for path, a, b in zip(paths, jl, T.flatten_up_to(paths, back)):
        assert b.dtype == a.dtype, T.keystr(path)
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))
    # the values, not only the bits: the port reads what JAX wrote
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(), np.asarray(params["embed"], np.float32))


def test_trees_with_lists_cross_over():
    """Unscanned layers sit in a list under "tail", as in jax.tree."""
    import dataclasses
    cfg = dataclasses.replace(JCFG, scan_layers=False)
    params = JM.init(jax.random.key(2), cfg, 0)
    tp = params_from_jax(jax.device_get(params))
    assert isinstance(tp["tail"], list) and len(tp["tail"]) == 2
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [T.keystr(p) for p in T.flatten(tp)[0]] == jpaths
    tcfg = dataclasses.replace(TCFG, scan_layers=False)
    prompt = np.arange(1, 9)[None]
    _close(TM.prefill(tp, tcfg, _t(prompt).long())[0],
           JM.prefill(params, cfg, jnp.asarray(prompt, jnp.int32))[0])


@pytest.mark.parametrize("arch", list(jcfgs.registry()))
def test_every_jax_arch_builds_in_the_port(arch):
    """Each of the JAX package's 12 archs is a config of the port, whose
    bundle builds and whose init (reduced for an LM) gives the tree of
    the reference's init: paths and shapes."""
    from repro.models import registry as JR
    from repro_torch.models import build
    jc, tc = jcfgs.get(arch), tcfgs.get(arch)
    assert tc.name == jc.name
    if arch != "dcgan32":
        jc, tc = jc.reduced(), tc.reduced()
    want = jax.eval_shape(lambda k: JR.build(jc).init(k, max_seq=16),
                          jax.random.key(0))
    got = build(tc).init(generator=torch.Generator().manual_seed(0),
                         max_seq=16)
    jp, jl = T.flatten(want)
    tp, tl = T.flatten(got)
    assert [T.keystr(p) for p in tp] == [T.keystr(p) for p in jp]
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
