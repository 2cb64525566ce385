"""Port parity: the MoE FFN of `repro_torch.models.moe` against
`repro.models.moe`, and the MoE archs' serving path, on the reduced
qwen3-moe-30b-a3b (4 experts, top-2) and arctic-480b (4 experts, top-2,
a dense residual), with the JAX weights carried across by
`convert.params_from_jax` and the same numpy inputs on both sides.

Tolerances:
  * float32: atol/rtol 1e-5 (both sides compute in float32 on the CPU;
    sums run in other orders, a few ulps an output).
  * bfloat16 `moe_apply`: within one bfloat16 ulp of the reference's
    largest |y| (the router computes in float32 on both sides, so the
    routes agree; the expert products round where the reference's do).
  * the aux losses (float32 on both sides): rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from torch_ranks import one_thread  # noqa: F401 (autouse)

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _cfgs(arch, **changes):
    """(JAX, port) reduced configs of `arch`, with `changes` and MoE
    changes (keys prefixed "moe_") applied to both."""
    moe = {k[4:]: v for k, v in changes.items() if k.startswith("moe_")}
    rest = {k: v for k, v in changes.items() if not k.startswith("moe_")}
    out = []
    for get in (jcfgs.get, tcfgs.get):
        c = get(arch).reduced()
        out.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, **moe), **rest))
    return out


def _moe_case(arch, dtype="float32", **changes):
    jc, tc = _cfgs(arch, param_dtype=dtype, **changes)
    p = JMoE.moe_init(jax.random.key(1), jc, jnp.dtype(dtype))
    x = jnp.asarray(np.random.RandomState(2).randn(2, 16, jc.d_model),
                    jnp.float32).astype(dtype)
    yj, aj = JMoE.moe_apply(p, jc, x)
    yt, at = TMoE.moe_apply(params_from_jax(jax.device_get(p)), tc,
                            params_from_jax(jax.device_get(x)))
    return jc, (yj, aj), (yt, at)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5],
                         ids=["no_dropping", "dropping"])
@pytest.mark.parametrize("dispatch", ["global", "per_row"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches(arch, dispatch, capacity_factor):
    """Output and aux losses under both dispatch modes; at capacity
    factor 0.5 a quarter of the routed slots fit (cap 4 of 16 tokens ×
    top-2 over 4 experts a row), so tokens are dropped."""
    jc, (yj, aj), (yt, at) = _moe_case(arch, moe_dispatch=dispatch,
                                       moe_capacity_factor=capacity_factor)
    assert tuple(yt.shape) == yj.shape and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert sorted(at) == sorted(aj) == ["moe_load_balance", "moe_router_z"]
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5)
    if capacity_factor < 1:
        # the case drops: fewer slots than routed tokens per expert
        S, m = 16, jc.moe
        cap = max(m.top_k, -(-m.top_k * S * m.capacity_factor
                             // m.num_experts))
        assert cap * m.num_experts < S * m.top_k


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bfloat16(arch):
    _, (yj, aj), (yt, at) = _moe_case(arch, "bfloat16",
                                      moe_capacity_factor=0.5)
    assert yt.dtype == torch.bfloat16
    want = np.asarray(yj.astype(jnp.float32))
    np.testing.assert_allclose(yt.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(np.abs(want).max()))
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5)


def test_moe_dense_residual_is_added():
    """Arctic's dense FFN runs beside the experts: without it the output
    differs by exactly that FFN, on both sides."""
    jc, tc = _cfgs("arctic-480b")
    p = JMoE.moe_init(jax.random.key(3), jc, jnp.float32)
    assert "dense" in p
    x = np.random.RandomState(4).randn(2, 8, jc.d_model).astype(np.float32)
    tp = params_from_jax(jax.device_get(p))
    yt, _ = TMoE.moe_apply(tp, tc, torch.from_numpy(x))
    yt0, _ = TMoE.moe_apply({k: v for k, v in tp.items() if k != "dense"},
                            tc, torch.from_numpy(x))
    from repro_torch.models.layers import mlp
    dense = mlp(tp["dense"], torch.from_numpy(x).reshape(16, -1),
                tc.activation).reshape(2, 8, -1)
    np.testing.assert_allclose(yt.numpy(), (yt0 + dense).numpy(), **TOL)
    yj, _ = JMoE.moe_apply(p, jc, jnp.asarray(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_tree_matches(arch):
    """Same leaves, shapes and dtypes (the router float32 in bf16 too)."""
    jc, tc = _cfgs(arch, param_dtype="bfloat16")
    jp = jax.eval_shape(lambda: JMoE.moe_init(jax.random.key(0), jc,
                                              jnp.bfloat16))
    tp = TMoE.moe_init(tc, generator=torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    paths, jl = T.flatten(jp)
    assert [T.keystr(p) for p in T.flatten(tp)[0]] == [T.keystr(p)
                                                       for p in paths]
    for path, a, b in zip(paths, jl, T.flatten_up_to(paths, tp)):
        assert tuple(b.shape) == a.shape, T.keystr(path)
        assert str(b.dtype)[6:] == str(a.dtype), T.keystr(path)
    assert tp["router"]["w"].dtype == torch.float32


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """(arch, JAX config, port config, JAX params, port params): the
    reduced MoE LM with weights moved off their init scale."""
    jc, tc = _cfgs(request.param)
    rs = np.random.RandomState(5)
    params = jax.tree.map(
        lambda w: w + 0.02 * rs.randn(*w.shape).astype(np.float32),
        JM.init(jax.random.key(0), jc, 0))
    return (request.param, jc, tc, params,
            params_from_jax(jax.device_get(params)))


def test_moe_prefill_and_decode_logits_match(lm):
    """MoE is served too: prefill logits and caches, then two
    teacher-forced decode steps (one token a row: capacity top_k)."""
    _, jc, tc, params, tparams = lm
    rs = np.random.RandomState(6)
    prompt = rs.randint(1, jc.vocab_size, (2, 12))
    lg_j, c_j = JM.prefill(params, jc, jnp.asarray(prompt, jnp.int32),
                           max_len=16)
    lg_t, c_t = TM.prefill(tparams, tc, torch.from_numpy(prompt).long(),
                           max_len=16)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    for _ in range(2):
        tok = rs.randint(1, jc.vocab_size, (2, 1))
        lg_j, c_j = JM.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                   c_j)
        lg_t, c_t = TM.decode_step(tparams, tc, torch.from_numpy(tok).long(),
                                   c_t)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    paths, jl = T.flatten(jax.device_get(c_j))
    for path, a, b in zip(paths, jl, T.flatten_up_to(paths, c_t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL,
                                   err_msg=T.keystr(path))


def test_moe_forward_aux_matches(lm):
    """The router's aux losses summed over the layers, in train mode."""
    _, jc, tc, params, tparams = lm
    toks = np.random.RandomState(7).randint(0, jc.vocab_size, (2, 16))
    _, _, aj = JM.forward(params, jc, jnp.asarray(toks, jnp.int32),
                          jnp.arange(16))
    _, caches, at = TM.forward(tparams, tc, torch.from_numpy(toks).long(),
                               torch.arange(16))
    assert caches is None
    assert sorted(at) == sorted(aj) == ["moe_load_balance", "moe_router_z"]
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5)
