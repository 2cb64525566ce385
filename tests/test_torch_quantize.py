"""Port parity: the fused quantize+EF wrappers of `repro_torch.kernels`
against the Pallas kernel (interpret mode) and its jnp oracle.

On the CPU the port's wrappers run the kernel's plain version, so these
tests pin the arithmetic the CUDA kernel must reproduce; the kernel itself
is compared with the plain version on the card by `chip_smoke.py` and by
`tests/test_torch_cuda.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as JQ
from repro.kernels.ref import quantize_ef_ref as jax_quantize_ef_ref
from repro_torch.kernels import quantize as Q
from repro_torch.kernels.ref import quantize_ef_ref


def _operands(seed, rows, cols):
    rs = np.random.RandomState(seed)
    g = (0.3 * rs.randn(rows, cols)).astype(np.float32)
    e = (0.05 * rs.randn(rows, cols)).astype(np.float32)
    r = rs.rand(rows, cols).astype(np.float32)
    return g, e, r


def _assert_same(jax_out, torch_out, max_flip=1e-4):
    """scale: bit-equal (a max and one exact add). codes: equal except where
    rand sits within float rounding of the fractional level, which the two
    frameworks may round differently (allow 1e-4 of the elements). e_new:
    within float32 rounding where the codes agree."""
    jc, js, je = (np.asarray(x, np.float32) for x in jax_out)
    tc, ts, te = (x.float().numpy() for x in torch_out)
    np.testing.assert_array_equal(ts, js)
    same = jc == tc
    assert (~same).mean() <= max_flip, (~same).mean()
    np.testing.assert_allclose(te[same], je[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,cols", [(8, 128), (64, 256), (256, 512),
                                       (32, 1024), (648, 1024)])
@pytest.mark.parametrize("levels", [127, 7, 1])
def test_quantize_ef_blocked_matches_pallas(rows, cols, levels):
    g, e, r = _operands(rows * cols + levels, rows, cols)
    br = min(rows, 216 if rows == 648 else 64)
    out_j = JQ.quantize_ef_blocked(jnp.asarray(g), jnp.asarray(e),
                                   jnp.asarray(r), levels=levels,
                                   block_rows=br, interpret=True)
    out_t = Q.quantize_ef_blocked(torch.from_numpy(g), torch.from_numpy(e),
                                  torch.from_numpy(r), levels=levels,
                                  block_rows=br)
    _assert_same(out_j, out_t)


@pytest.mark.parametrize("edit", ["zero_row", "huge_value", "none"])
def test_quantize_ef_ref_matches_jax_ref(edit):
    g, e, r = _operands(7, 16, 1024)
    if edit == "zero_row":
        g[3] = 0.0
        e[3] = 0.0
    elif edit == "huge_value":
        g[5, 17] = 3.0e20
    out_j = jax_quantize_ef_ref(jnp.asarray(g), jnp.asarray(e),
                                jnp.asarray(r))
    out_t = quantize_ef_ref(torch.from_numpy(g), torch.from_numpy(e),
                            torch.from_numpy(r))
    _assert_same(out_j, out_t)
    if edit == "zero_row":
        assert not out_t[0][3].any() and not out_t[2][3].any()


@pytest.mark.parametrize("n", [1024, 8 * 1024, 648 * 1024, 512 * 1024,
                               3 * 128])
def test_quantize_ef_flat_matches_pallas(n):
    g, e, r = (x.reshape(-1) for x in _operands(n, 1, n))
    out_j = JQ.quantize_ef_flat(jnp.asarray(g), jnp.asarray(e),
                                jnp.asarray(r), interpret=True)
    out_t = Q.quantize_ef_flat(torch.from_numpy(g), torch.from_numpy(e),
                               torch.from_numpy(r))
    assert [tuple(x.shape) for x in out_t] == [x.shape for x in out_j]
    _assert_same(out_j, out_t)


def test_bucket_tile_shape_sweep():
    ns = sorted({128 * k for k in range(1, 200, 7)}
                | {1024 * k for k in (1, 3, 257, 512, 648, 1000, 1811)})
    for n in ns:
        assert Q.bucket_tile_shape(n) == JQ.bucket_tile_shape(n), n
    with pytest.raises(ValueError):
        Q.bucket_tile_shape(1000)
    with pytest.raises(AssertionError):
        JQ.bucket_tile_shape(1000)


def test_dcgan32_bucket_tiles():
    """The three dcgan32 buckets of qsgd8_block1024/uniform tile as
    (648, 1024, 216), (648, 1024, 216), (512, 1024, 256)."""
    assert [Q.bucket_tile_shape(R * 1024) for R in (648, 648, 512)] == [
        (648, 1024, 216), (648, 1024, 216), (512, 1024, 256)]


def test_cpu_calls_do_not_count_as_launches():
    g, e, r = (torch.from_numpy(x) for x in _operands(0, 8, 128))
    before = Q.launches
    Q.quantize_ef_blocked(g, e, r)
    assert Q.launches == before


def test_non_cpu_tensors_go_to_the_kernel_never_the_plain_version():
    """A tensor that is not on the CPU is the kernel's: a device it cannot
    run on raises instead of falling back to the plain version."""
    g = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        Q.quantize_ef_blocked(g, g, g)


def test_shape_contract_is_checked():
    g, e, r = (torch.from_numpy(x) for x in _operands(0, 8, 100))
    with pytest.raises(ValueError, match="lane-align"):
        Q.quantize_ef_blocked(g, e, r)
    g, e, r = (torch.from_numpy(x) for x in _operands(0, 12, 128))
    with pytest.raises(ValueError, match="block_rows"):
        Q.quantize_ef_blocked(g, e, r, block_rows=8)
