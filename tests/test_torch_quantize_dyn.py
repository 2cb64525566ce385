"""Port parity: the dynamic-levels quantize+EF path (the Pallas
`_quantize_ef_kernel_dyn`, B2) and `TracedQuant` of `repro_torch` against
the JAX package, with the level count traced under `jax.jit` on the JAX
side (the kernel in interpret mode) and a one-element float32 tensor on
the port's side.

On the CPU the port's wrappers run the kernel's plain version; the CUDA
kernel is held against that plain version on the card (`chip_smoke.py`,
`tests/test_torch_cuda.py`).

Tolerances: scales are a max and one exact add (bit-equal); codes may
differ only where a uniform draw sits within float rounding of the
fractional level (at most 1e-4 of the elements, expected none); residuals
and dequantized values then agree to float32 rounding where the codes do.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.core import error_feedback as JEF
from repro.kernels import quantize as JQ
from repro_torch.core import compressors as TC
from repro_torch.core import error_feedback as TEF
from repro_torch.kernels import quantize as Q
from torch_ranks import one_thread  # noqa: F401 (autouse)

LEVELS = [127, 7, 1]


def _operands(seed, rows, cols):
    rs = np.random.RandomState(seed)
    return ((0.3 * rs.randn(rows, cols)).astype(np.float32),
            (0.05 * rs.randn(rows, cols)).astype(np.float32),
            rs.rand(rows, cols).astype(np.float32))


def _lv(levels):
    return torch.tensor([float(levels)])


def _assert_same(jax_out, torch_out, max_flip=1e-4):
    jc, js, je = (np.asarray(x, np.float32) for x in jax_out)
    tc, ts, te = (x.float().numpy() for x in torch_out)
    np.testing.assert_array_equal(ts, js)
    same = jc == tc
    assert (~same).mean() <= max_flip, (~same).mean()
    np.testing.assert_allclose(te[same], je[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,cols", [(8, 128), (64, 1024), (648, 1024)])
@pytest.mark.parametrize("levels", LEVELS)
def test_plain_b2_matches_pallas_dyn_kernel(rows, cols, levels):
    g, e, r = _operands(rows + levels, rows, cols)
    br = min(rows, 216 if rows == 648 else 64)
    dyn = jax.jit(lambda g, e, r, lv: JQ.quantize_ef_blocked(
        g, e, r, levels=lv, block_rows=br, interpret=True))
    out_j = dyn(jnp.asarray(g), jnp.asarray(e), jnp.asarray(r),
                jnp.float32(levels))
    out_t = Q.quantize_ef_blocked(torch.from_numpy(g), torch.from_numpy(e),
                                  torch.from_numpy(r), levels=_lv(levels),
                                  block_rows=br)
    _assert_same(out_j, out_t)


@pytest.mark.parametrize("levels", LEVELS)
def test_b2_plain_version_equals_b1_plain_version(levels):
    """The device level count changes nothing but where L comes from."""
    g, e, r = (torch.from_numpy(x) for x in _operands(3, 32, 1024))
    a = Q.quantize_ef_blocked(g, e, r, levels=levels)
    b = Q.quantize_ef_blocked(g, e, r, levels=_lv(levels))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("levels", LEVELS)
def test_flat_b2_matches_pallas(levels):
    n = 6 * 1024
    g, e, r = (x.reshape(n) for x in _operands(levels, 6, 1024))
    dyn = jax.jit(lambda g, e, r, lv: JQ.quantize_ef_flat(
        g, e, r, levels=lv, interpret=True))
    out_j = dyn(jnp.asarray(g), jnp.asarray(e), jnp.asarray(r),
                jnp.float32(levels))
    out_t = Q.quantize_ef_flat(torch.from_numpy(g), torch.from_numpy(e),
                               torch.from_numpy(r), levels=_lv(levels))
    _assert_same(out_j, out_t)


def _jax_traced(levels, per_block, fn):
    """Run fn(TracedQuant) under jit with the level count traced."""
    return jax.jit(lambda lv, *a: fn(JC.TracedQuant(lv, per_block=per_block),
                                     *a))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("shape,per_block", [((4096,), 1024), ((17, 40), 0),
                                             ((3000,), 1024)])
def test_traced_quant_compress_decompress(levels, shape, per_block):
    v = np.random.RandomState(levels).randn(*shape).astype(np.float32)
    key = jax.random.key(5)
    d = math.prod(shape)
    fb = (1, d) if per_block <= 0 else (-(-d // per_block), per_block)
    rand = np.array(jax.random.uniform(key, fb))

    def roundtrip(c, v, k):
        p = c.compress(v, k)
        return p, c.decompress(p, v.shape, jnp.float32)

    pj, vj = _jax_traced(levels, per_block, roundtrip)(
        jnp.float32(levels), jnp.asarray(v), key)
    tq = TC.TracedQuant(_lv(levels), per_block=per_block)
    pt = tq.compress(torch.from_numpy(v), rand=torch.from_numpy(rand))
    vt = tq.decompress(pt, shape, torch.float32)
    np.testing.assert_array_equal(pt["scale"].numpy(), np.asarray(pj["scale"]))
    same = np.asarray(pj["codes"]) == pt["codes"].numpy()
    assert (~same).mean() <= 1e-4
    if same.all():
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-6)
    # a Python int level count computes the same as the tensor one
    ti = TC.TracedQuant(levels, per_block=per_block)
    pi = ti.compress(torch.from_numpy(v), rand=torch.from_numpy(rand))
    assert torch.equal(pi["codes"], pt["codes"])
    assert torch.equal(ti.decompress(pi, shape, torch.float32), vt)


@pytest.mark.parametrize("levels", LEVELS)
def test_traced_quant_takes_the_fused_path(levels):
    """Over a flat 1024-aligned bucket both packages run the fused
    (dynamic-levels) kernel for a TracedQuant; elsewhere the generic
    compress."""
    n = 4096
    msg = np.random.RandomState(1).randn(n).astype(np.float32)
    e = 0.01 * np.random.RandomState(2).randn(n).astype(np.float32)
    key = jax.random.key(9)
    jq = JC.TracedQuant(jnp.float32(levels), per_block=1024)
    assert JEF.fused_compatible(jq, jnp.asarray(msg))
    tq = TC.TracedQuant(_lv(levels), per_block=1024)
    assert TEF.fused_compatible(tq, torch.from_numpy(msg))
    assert not TEF.fused_compatible(tq, torch.from_numpy(msg[:1000]))
    assert not TEF.fused_compatible(TC.TracedQuant(_lv(levels)),
                                    torch.from_numpy(msg))
    pj, mj, ej = jax.jit(lambda lv, m, e, k: JEF.compress_with_ef(
        JC.TracedQuant(lv, per_block=1024), m, e, k))(
        jnp.float32(levels), jnp.asarray(msg), jnp.asarray(e), key)
    rand = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    pt, mt, et = TEF.compress_with_ef(tq, torch.from_numpy(msg),
                                      torch.from_numpy(e), rand)
    np.testing.assert_array_equal(pt["scale"].numpy(), np.asarray(pj["scale"]))
    same = np.asarray(pj["codes"]) == pt["codes"].numpy()
    assert (~same).mean() <= 1e-4
    np.testing.assert_allclose(mt.numpy() + et.numpy(),
                               np.asarray(mj) + np.asarray(ej), rtol=0,
                               atol=1e-6)
    flat_same = same.reshape(-1)
    np.testing.assert_allclose(et.numpy()[flat_same],
                               np.asarray(ej)[flat_same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("comp", [TC.TracedQuant(_lv(7), per_block=1024),
                                  TC.get("qsgd8_block1024"),
                                  TC.get("qsgd8_linf")])
@pytest.mark.parametrize("use_ef", [True, False])
def test_stacked_compress_equals_each_worker_alone(comp, use_ef):
    """One call over the (W, n) stack (one kernel launch on the fused
    path) equals W per-worker calls with the same draws."""
    W, n = 4, 3 * 1024
    rs = np.random.RandomState(4)
    m = torch.from_numpy(rs.randn(W, n).astype(np.float32))
    e = torch.from_numpy(0.01 * rs.randn(W, n).astype(np.float32))
    rand = torch.from_numpy(rs.rand(W, n).astype(np.float32))
    pay, mh, en = TEF.compress_with_ef_stacked(comp, m, e, rand,
                                               use_ef=use_ef)
    for w in range(W):
        pw, mw, ew = TEF.compress_with_ef(comp, m[w], e[w], rand[w],
                                          use_ef=use_ef)
        assert torch.equal(mh[w], mw) and torch.equal(en[w], ew)
        for k in pw:
            assert torch.equal(pay[k][w], pw[k])


def test_levels_operand_is_checked():
    g, e, r = (torch.from_numpy(x) for x in _operands(0, 8, 128))
    with pytest.raises(ValueError, match="one element"):
        Q.quantize_ef_blocked(g, e, r, levels=torch.tensor([7.0, 7.0]))
    with pytest.raises(ValueError, match="float32"):
        Q.quantize_ef_blocked(g, e, r, levels=torch.tensor([7]))
    with pytest.raises(TypeError):
        Q.quantize_ef_blocked(g, e, r, levels=7.0)
    with pytest.raises(ValueError, match="levels is on"):
        Q.quantize_ef_blocked(g, e, r,
                              levels=torch.empty((1,), device="meta"))


def test_cpu_b2_calls_do_not_count_and_other_devices_go_to_the_kernel():
    g, e, r = (torch.from_numpy(x) for x in _operands(0, 8, 128))
    before = (Q.launches, Q.launches_dyn)
    Q.quantize_ef_blocked(g, e, r, levels=_lv(7))
    assert (Q.launches, Q.launches_dyn) == before
    m = torch.empty((8, 128), device="meta")
    lv = torch.empty((1,), device="meta")
    before = (Q.launches, Q.launches_dyn, Q.meta_launches_dyn)
    codes, _, _ = Q.quantize_ef_blocked(m, m, m, levels=lv)   # the meta form
    assert codes.device.type == "meta"
    assert (Q.launches, Q.launches_dyn, Q.meta_launches_dyn) == \
        (before[0], before[1], before[2] + 1)
    with pytest.raises(ValueError, match="CUDA"):
        Q._launch(m, m, m, lv)
