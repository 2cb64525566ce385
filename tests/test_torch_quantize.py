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


def _packed(seed, bucket_rows):
    """Flat buckets of the given row counts, and the same packed back to
    back: (g, e, r) lists per bucket and the three packed buffers."""
    parts = [tuple(x.reshape(-1) for x in _operands(seed + i, R, 1024))
             for i, R in enumerate(bucket_rows)]
    packed = [np.concatenate([p[k] for p in parts]) for k in range(3)]
    return parts, packed


@pytest.mark.parametrize("bucket_rows", [(648, 648, 512), (3, 1, 5), (4,),
                                         (1,), (2, 1)])
@pytest.mark.parametrize("levels", [127, 7])
def test_quantize_ef_flat_on_packed_buckets_equals_per_bucket_calls(
        bucket_rows, levels):
    """One call over comm buckets packed back to back (the one-worker
    trainer's single B1 launch) gives each bucket's rows exactly what
    `quantize_ef_flat` gives that bucket alone."""
    parts, packed = _packed(sum(bucket_rows) + levels, bucket_rows)
    codes, scales, e_new = Q.quantize_ef_flat(
        *(torch.from_numpy(x) for x in packed), levels=levels)
    assert codes.shape == (packed[0].size,) and codes.dtype == torch.int8
    assert scales.shape == (sum(bucket_rows),)
    c0 = r0 = 0
    for (g, e, r), R in zip(parts, bucket_rows):
        want = Q.quantize_ef_flat(torch.from_numpy(g), torch.from_numpy(e),
                                  torch.from_numpy(r), levels=levels)
        n = R * 1024
        assert torch.equal(codes[c0:c0 + n], want[0])
        assert torch.equal(scales[r0:r0 + R], want[1])
        assert torch.equal(e_new[c0:c0 + n], want[2])
        c0, r0 = c0 + n, r0 + R


@pytest.mark.parametrize("bucket_rows", [(3, 1, 5), (8,), (1,)])
def test_quantize_ef_flat_on_packed_buckets_matches_pallas(bucket_rows):
    """Each bucket's slice of the call over the packed buckets against the
    Pallas kernel (interpret mode) on that bucket alone."""
    parts, packed = _packed(7 * sum(bucket_rows), bucket_rows)
    codes, scales, e_new = Q.quantize_ef_flat(
        *(torch.from_numpy(x) for x in packed), levels=127)
    c0 = r0 = 0
    for (g, e, r), R in zip(parts, bucket_rows):
        out_j = JQ.quantize_ef_flat(jnp.asarray(g), jnp.asarray(e),
                                    jnp.asarray(r), interpret=True)
        n = R * 1024
        _assert_same(out_j, (codes[c0:c0 + n], scales[r0:r0 + R],
                             e_new[c0:c0 + n]))
        c0, r0 = c0 + n, r0 + R


def test_quantize_ef_flat_on_packed_buckets_dispatches_by_device():
    """CPU operands take the plain version (no launch counted); anything
    but CUDA is refused, never computed some other way."""
    g, e, r = (torch.from_numpy(x.reshape(-1)) for x in _operands(0, 2, 1024))
    before = Q.launches
    codes, scales, _ = Q.quantize_ef_flat(g, e, r)
    assert Q.launches == before
    assert codes.shape == (2048,) and scales.shape == (2,)
    m = torch.empty((2048,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        Q.quantize_ef_flat(m, m, m)
