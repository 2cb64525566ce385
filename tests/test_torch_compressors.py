"""Port parity: `repro_torch.core.compressors` and `error_feedback` against
`repro.core`, with the JAX package's draws handed to the port.

Tolerances: scales and kept values are float32 reductions or copies
(rtol 1e-6); codes may differ only where a uniform draw sits within float
rounding of the fractional level (at most 1e-3 of the elements, expected
none); dequantized values and residuals then agree to 1e-6 where the codes
do."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import ledger as JL
from repro.core import compressors as JC
from repro.core import error_feedback as JEF
from repro_torch.comm import ledger as TL
from repro_torch.core import compressors as TC
from repro_torch.core import error_feedback as TEF
from torch_ranks import one_thread  # noqa: F401 (autouse)

NAMES = sorted(JC.REGISTRY)
SHAPES = [(300,), (17, 40), (4096,), (2, 1024)]


def jax_draw(comp, shape, key, fused=False):
    """The random numbers the JAX package draws from `key` for this
    compressor and shape (None for deterministic compressors)."""
    d = math.prod(shape)
    if fused:
        return np.asarray(jax.random.uniform(key, (d,)))
    if isinstance(comp, JC.StochasticQuant):
        b = comp.per_block
        fb = (1, d) if b <= 0 else (-(-d // b), b)
        return np.asarray(jax.random.uniform(key, fb))
    if isinstance(comp, JC.RandK):
        return np.asarray(jax.random.choice(key, d, (comp._k(d),),
                                            replace=False))
    return None


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _vec(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_registry_names_and_types():
    assert sorted(TC.REGISTRY) == NAMES
    for name in NAMES:
        j, t = JC.REGISTRY[name], TC.REGISTRY[name]
        assert type(j).__name__ == type(t).__name__
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == \
            {f: getattr(t, f) for f in t.__dataclass_fields__}


@pytest.mark.parametrize("name", NAMES)
def test_wire_bytes_delta_and_payload_bytes_match(name):
    j, t = JC.get(name), TC.get(name)
    for shape in SHAPES + [(1,), (1811, 1024), (64, 3, 4, 4)]:
        for W in (1, 2, 8):
            assert t.wire_bytes(shape, W) == j.wire_bytes(shape, W)
        d = math.prod(shape)
        assert t.delta(d) == j.delta(d)
        assert TL.payload_nbytes(t, shape) == JL.payload_nbytes(j, shape)
    assert t.unbiased == j.unbiased


def _compare_payload(pj, pt):
    assert sorted(pj) == sorted(pt)
    for k in pj:
        a, b = np.asarray(pj[k]), pt[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if k == "codes":
            assert (a != b).mean() <= 1e-3
        elif k == "indices":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES)
def test_compress_decompress_with_injected_draws(name, shape):
    j, t = JC.get(name), TC.get(name)
    v = _vec(len(name) + math.prod(shape), shape)
    key = jax.random.key(3)
    pj = j.compress(jnp.asarray(v), key)
    pt = t.compress(torch.from_numpy(v), rand=_t(jax_draw(j, shape, key)))
    _compare_payload(pj, pt)
    vj = np.asarray(j.decompress(pj, shape, jnp.float32))
    vt = t.decompress(pt, shape, torch.float32).numpy()
    assert vt.shape == vj.shape
    if "codes" in pj and (np.asarray(pj["codes"])
                          != pt["codes"].numpy()).any():
        return  # a boundary flip: one quantization step on that element
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["qsgd8_linf", "qsgd8_block1024",
                                  "qsgd4_block1024", "qsgd2_block1024",
                                  "qsgd8_block256", "topk10", "sign",
                                  "identity", "randk1", "qsgd8_l2"])
@pytest.mark.parametrize("shape", [(4096,), (3 * 1024,), (17, 40), (300,)])
@pytest.mark.parametrize("use_ef", [True, False])
def test_compress_with_ef_per_leaf_and_fused(name, shape, use_ef):
    """Both packages take the fused kernel path for the block-1024 linf
    quantizers over a flat 1024-aligned operand (the plain version on the
    CPU here), and the generic compress path otherwise."""
    j, t = JC.get(name), TC.get(name)
    msg = _vec(1, shape)
    e = 0.01 * _vec(2, shape)
    key = jax.random.key(11)
    fused = use_ef and JEF.fused_compatible(j, jnp.asarray(msg))
    assert fused == (use_ef and TEF.fused_compatible(t, torch.from_numpy(msg)))
    pj, mj, ej = JEF.compress_with_ef(j, jnp.asarray(msg), jnp.asarray(e),
                                      key, use_ef=use_ef)
    pt, mt, et = TEF.compress_with_ef(
        t, torch.from_numpy(msg), torch.from_numpy(e),
        _t(jax_draw(j, shape, key, fused)), use_ef=use_ef)
    _compare_payload(pj, pt)
    ej, et = np.asarray(ej), et.numpy()
    mj, mt = np.asarray(mj), mt.numpy()
    # EF keeps m_hat + e_new = m whatever the codes did
    np.testing.assert_allclose(mt + et, mj + ej, rtol=0, atol=1e-6)
    if "codes" not in pj or (np.asarray(pj["codes"])
                             == pt["codes"].numpy()).all():
        # e_new = m − q·s/L cancels down from |m|: a few float32 ulps of
        # max|m| (XLA may contract the product and difference into an FMA)
        atol = 4 * np.finfo(np.float32).eps * np.abs(msg + e).max()
        np.testing.assert_allclose(mt, mj, rtol=0, atol=atol)
        np.testing.assert_allclose(et, ej, rtol=0, atol=atol)


def test_fused_payload_layout_matches_blocked_quantizer():
    """fused_quantize_ef emits the blocked StochasticQuant payload layout, so
    StochasticQuant.decompress consumes it unchanged."""
    msg, e = _vec(5, (8192,)), 0.01 * _vec(6, (8192,))
    rand = np.random.RandomState(7).rand(8192).astype(np.float32)
    payload, m_hat, _ = TEF.fused_quantize_ef(
        torch.from_numpy(msg), torch.from_numpy(e), torch.from_numpy(rand))
    assert payload["codes"].shape == (8, 1024)
    assert payload["scale"].shape == (8, 1)
    deq = TC.get("qsgd8_block1024").decompress(payload, (8192,),
                                               torch.float32)
    torch.testing.assert_close(deq, m_hat, rtol=0, atol=1e-7)


def test_lemma1_bound_matches():
    for args in [(1e-3, 0.5, 1.0, 0.1, 64), (0.05, 0.99, 3.0, 2.0, 8)]:
        assert TEF.lemma1_bound(*args) == JEF.lemma1_bound(*args)
