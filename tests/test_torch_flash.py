"""Port parity: B4's plain version and the port's `flash_attention` against
`repro.kernels.ref.flash_attention_ref` and the Pallas
`repro.kernels.flash_attention.flash_attention` (interpret mode, as
tests/test_kernels.py runs it), on the same numpy inputs.

On the CPU the port's wrapper runs its plain version
(`kernels.ref.flash_attention_ref`), so these tests pin the function the
CUDA kernel computes; the kernel itself is held against the plain version
on the card by `chip_smoke.py` and `tests/test_torch_cuda.py`.

Tolerances: the references to each other within 1e-5 in float32 (the same
sums in another order) and one bfloat16 ulp in bfloat16 (both compute in
float32 and round once); the port against the Pallas kernel within 2e-4
in float32 and 2e-2 in bfloat16, the bounds tests/test_kernels.py holds
the Pallas kernel to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels.ref import flash_attention_ref
from torch_ranks import one_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(seed, shape, dtype):
    """(jax, torch) pairs of q, k, v with the same values: numpy float32
    from `seed`, rounded to `dtype` the same way on both sides."""
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(seed)
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(x).astype(jd) for x in xs],
            [torch.from_numpy(x).to(td) for x in xs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of max|x|."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256])
def test_plain_version_matches_jax_reference(S, D, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(S + D, (2, S, 2, D), dtype)
    want = _f32(j_flash_ref(jq, jk, jv, causal=causal))
    got = flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, S, 2, D)
    err = float(np.abs(_f32(got) - want).max())
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(want)
    assert err <= tol, (err, tol)


BLOCKS = [(128, 128), (128, 64), (64, 128)]


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256])
def test_flash_attention_matches_pallas_kernel(S, D, causal, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(3 * S + D, (4, S, D), "float32")
    want = _f32(j_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk))
    got = TF.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.float32 and got.shape == (4, S, D)
    np.testing.assert_allclose(_f32(got), want, rtol=TOL["float32"],
                               atol=TOL["float32"])


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_pallas_kernel(causal, bq, bk):
    """tests/test_kernels.py's bf16 shape, (2, 256, 128)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, (2, 256, 128), "bfloat16")
    want = _f32(j_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk))
    got = TF.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_flash_attention_small_tiles(dtype, causal):
    """S = 24 with bq = bk = 8: legal for the JAX kernel, and not a
    multiple of the CUDA kernel's own tiles."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(24, (3, 24, 64), dtype)
    want = _f32(j_flash(jq, jk, jv, causal=causal, bq=8, bk=8))
    got = TF.flash_attention(tq, tk, tv, causal=causal, bq=8, bk=8)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    _, (q, k, v) = _inputs(1, (2, 64, 32), "float32")
    TF.reset_launches()
    got = TF.flash_attention(q, k, v, causal=True, bq=32, bk=16)
    want = flash_attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=True)[:, :, 0]
    assert torch.equal(got, want)
    assert TF.flash_launches == 0 and TF.launches == 0


REFUSALS = {
    # case: (edit of (q, k, v), keyword arguments, message)
    "S % bq": (lambda q, k, v: (q, k, v), {"bq": 48, "bk": 32}, "bq=48"),
    "S % bk": (lambda q, k, v: (q, k, v), {"bq": 32, "bk": 48}, "bk=48"),
    "bq = 0": (lambda q, k, v: (q, k, v), {"bq": 0}, "bq=0"),
    "k shape": (lambda q, k, v: (q, k[:, :32], v), {}, "one shape"),
    "v shape": (lambda q, k, v: (q, k, v[:1]), {}, "one shape"),
    "q 4-D": (lambda q, k, v: (q[:, :, None], k, v), {}, "q must be"),
    "k 2-D": (lambda q, k, v: (q, k[0], v), {}, "k must be"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_flash_attention_refuses(case):
    edit, kw, match = REFUSALS[case]
    _, qkv = _inputs(2, (2, 64, 16), "float32")
    TF.reset_launches()
    with pytest.raises(ValueError, match=match):
        TF.flash_attention(*edit(*qkv), **kw)
    assert TF.flash_launches == 0
