"""Port parity: load-time weight quantization (`repro_torch.serve.
quantized_weights`, `repro_torch.comm.layout_for_params`) and the serving
engine with quantized weights, against `repro.serve` on gemma-2b
`reduced()` (2 layers, d 256, vocab 512, float32) with the JAX weights
carried across by `convert.params_from_jax`.

The port's B1 wrapper runs its plain version on CPU tensors, the JAX
side its Pallas kernel in interpret mode. The draws are the JAX
package's own (`fold_in(key(seed), bid)`, passed to the port as numpy
through `draws=`): threefry and Philox never agree, and with the same
draws codes and scales are held bit for bit, the rebuilt trees too, and
greedy tokens exactly (the logits agree to float32 rounding)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.comm.buckets import layout_for_params as j_layout
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeError as JServeError
from repro.serve import quantized_weights as JQ
from repro.strategy import Compression as JCompression
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.comm import layout_for_params
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import (
    Engine,
    Request,
    SequentialGenerator,
    ServeConfig,
    ServeError,
    WeightQuantMeta,
    dequantize_weights,
    quantize_weights,
)
from repro_torch.strategy import Compression
from torch_ranks import one_thread  # noqa: F401 (autouse)

JCFG = jcfgs.get("gemma-2b").reduced()
TCFG = tcfgs.get("gemma-2b").reduced()
SCFG = ServeConfig(max_batch=4, block_size=8, num_blocks=64,
                   max_blocks_per_seq=8, prompt_buckets=(8, 16, 32))

# (plan, bucket_mb, budget_mb): the JAX serving tests' settings; the
# budget lies between the all-2-bit floor and the all-8-bit payload
PLANS = {
    "uniform": ("uniform", 0.25, 0.0),
    "size_tiered": ("size_tiered", 0.0625, 0.0),
    "delta_budget": ("delta_budget", 0.0625, 1.0),
}


def _comps(name, compressor="qsgd8_linf"):
    plan, bucket_mb, budget_mb = PLANS[name]
    kw = dict(compressor=compressor, plan=plan, bucket_mb=bucket_mb,
              budget_mb=budget_mb)
    return JCompression(**kw), Compression(**kw)


def jax_draws(seed):
    """The JAX package's draws for bucket bid, as numpy."""
    key = jax.random.key(seed)
    return lambda bid, n: np.asarray(
        jax.random.uniform(jax.random.fold_in(key, bid), (n,)))


def _bits(x):
    """Bit pattern of a tensor or array, bfloat16 included."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint8)


@pytest.fixture(scope="module")
def weights():
    params = JM.init(jax.random.key(0), JCFG, 0)
    return params, params_from_jax(jax.device_get(params))


# --------------------------------------------------------------------------- #
# the layout
# --------------------------------------------------------------------------- #
def _layout_fields(layout):
    return (layout.n_workers, layout.align, layout.n_leaves,
            [(b.bid, b.size, b.used, b.padding,
              [(s.index, s.path, tuple(s.shape), s.size, s.bucket, s.offset)
               for s in b.slots]) for b in layout.buckets],
            [(s.index, s.path) for s in layout.skipped])


def _toy_tree(make):
    return {"enc": {"w": make((300, 40)), "b": make((40,))},
            "tail": [make((7, 9)), make((5000,))],
            "a": make((2, 3, 4))}


@pytest.mark.parametrize("tree", ["toy", "gemma-2b-reduced"])
@pytest.mark.parametrize("bucket_bytes", [4 << 20, 1 << 14])
def test_layout_for_params_matches_jax(weights, tree, bucket_bytes):
    if tree == "toy":
        jp = _toy_tree(np.zeros)
        tp = _toy_tree(torch.zeros)
    else:
        jp, tp = weights
    got = layout_for_params(tp, bucket_bytes=bucket_bytes)
    want = j_layout(jp, bucket_bytes=bucket_bytes)
    assert _layout_fields(got) == _layout_fields(want)
    assert got.describe() == want.describe()


# --------------------------------------------------------------------------- #
# quantize / dequantize
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("plan", list(PLANS))
def test_quantize_weights_matches_jax_on_its_draws(weights, plan):
    jparams, tparams = weights
    jcomp, tcomp = _comps(plan)
    jmeta, jpay = JQ.quantize_weights(jparams, jcomp, seed=4, interpret=True)
    meta, pay = quantize_weights(tparams, tcomp, draws=jax_draws(4))
    assert isinstance(meta, WeightQuantMeta)
    assert meta.levels == jmeta.levels and meta.bits == jmeta.bits
    assert meta.payload_bytes == jmeta.payload_bytes
    assert meta.f32_bytes == jmeta.f32_bytes
    assert meta.describe() == jmeta.describe()
    assert _layout_fields(meta.layout) == _layout_fields(jmeta.layout)
    assert sorted(pay) == sorted(jpay)
    for key, entry in jpay.items():
        assert sorted(pay[key]) == sorted(entry), key
        for field, want in entry.items():
            got = pay[key][field]
            assert got.dtype == {"codes": torch.int8, "scales": torch.float32,
                                 "flat": torch.float32}[field]
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{key}.{field}")
    raw = [lv == 0 for lv in meta.levels]
    if plan == "size_tiered":          # small buckets stay raw f32
        assert any(raw) and not all(raw)
    else:
        assert not any(raw)
    if plan == "delta_budget":
        assert len(set(meta.bits)) >= 2, meta.bits
    else:
        assert set(meta.bits) - {32} == {8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", ["uniform", "size_tiered"])
def test_dequantize_weights_bit_identical(weights, dtype, plan):
    jparams, _ = weights
    jparams = jax.tree.map(lambda w: w.astype(dtype), jparams)
    tparams = params_from_jax(jax.device_get(jparams))
    jcomp, tcomp = _comps(plan)
    jmeta, jpay = JQ.quantize_weights(jparams, jcomp, seed=2, interpret=True)
    meta, pay = quantize_weights(tparams, tcomp, draws=jax_draws(2))
    want = jax.device_get(JQ.dequantize_weights(jmeta, jpay))
    got = dequantize_weights(meta, pay)
    paths, wl = T.flatten(want)
    gl = T.flatten_up_to(paths, got)
    assert [T.keystr(p) for p in T.flatten(got)[0]] == \
        [T.keystr(p) for p in paths]
    for path, g, w in zip(paths, gl, wl):
        assert tuple(g.shape) == w.shape, T.keystr(path)
        assert g.dtype == getattr(torch, dtype), T.keystr(path)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=T.keystr(path))


def test_quantize_weights_draws_are_seeded(weights):
    """The default draws come from a generator seeded by (seed, bucket):
    the same seed gives the same payload bit for bit, another seed other
    codes; injected draws must have the bucket's length."""
    _, tparams = weights
    _, tcomp = _comps("uniform")
    _, a = quantize_weights(tparams, tcomp, seed=5)
    _, b = quantize_weights(tparams, tcomp, seed=5)
    _, c = quantize_weights(tparams, tcomp, seed=6)
    for k in a:
        for f in a[k]:
            assert torch.equal(a[k][f], b[k][f]), (k, f)
    assert any(not torch.equal(a[k]["codes"], c[k]["codes"]) for k in a)
    with pytest.raises(ValueError, match="draws"):
        quantize_weights(tparams, tcomp,
                         draws=lambda bid, n: np.zeros(n - 1, np.float32))


@pytest.mark.parametrize("compressor", ["qsgd8_l2", "sign", "topk10"])
def test_non_linf_compressors_are_refused(weights, compressor):
    """Both packages refuse a compressor that is not a linf quantizer,
    naming linf."""
    jparams, tparams = weights
    with pytest.raises(ServeError, match="linf"):
        quantize_weights(tparams, Compression(compressor=compressor))
    with pytest.raises(JServeError, match="linf"):
        JQ.quantize_weights(jparams, JCompression(compressor=compressor))


# --------------------------------------------------------------------------- #
# the engine and the sequential baseline
# --------------------------------------------------------------------------- #
def _requests(n, rng, max_new, cls):
    return [cls(rid=i,
                prompt=[int(t) for t in rng.integers(1, JCFG.vocab_size,
                                                     int(rng.integers(3, 40)))],
                max_new=max_new)
            for i in range(n)]


def _on_jax_draws(runner, tparams, tcomp, seed):
    """Re-quantize a runner's weights on the JAX package's draws."""
    runner.weights.meta, runner.weights.stored = quantize_weights(
        tparams, tcomp, draws=jax_draws(seed))
    return runner


@pytest.fixture(scope="module")
def jax_quantized_run(weights):
    """The JAX engine's tokens with 8-bit weights (seed 9), and its stats."""
    jparams, _ = weights
    jcomp, _ = _comps("uniform")
    eng = JEngine(JCFG, SCFG, jparams, compression=jcomp, seed=9)
    out = eng.run(_requests(5, np.random.default_rng(6), 5, JRequest))
    return out, eng.stats()["weights"]


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_quantized_engine_matches_the_jax_engine(weights, jax_quantized_run,
                                                 impl):
    _, tparams = weights
    _, tcomp = _comps("uniform")
    want, desc = jax_quantized_run
    eng = _on_jax_draws(Engine(TCFG, SCFG, tparams, compression=tcomp,
                               seed=9, attn_impl=impl), tparams, tcomp, 9)
    out = eng.run(_requests(5, np.random.default_rng(6), 5, Request))
    assert out == want
    assert eng.stats()["weights"] == desc and "8bx" in desc


def test_quantized_sequential_matches_the_jax_engine(weights,
                                                     jax_quantized_run):
    _, tparams = weights
    _, tcomp = _comps("uniform")
    want, desc = jax_quantized_run
    seq = _on_jax_draws(SequentialGenerator(TCFG, SCFG, tparams,
                                            compression=tcomp, seed=9),
                        tparams, tcomp, 9)
    for r in _requests(5, np.random.default_rng(6), 5, Request):
        assert seq.generate(list(r.prompt), r.max_new, rid=r.rid) \
            == want[r.rid], r.rid
    assert seq.stats()["weights"] == desc


@pytest.mark.parametrize("plan", ["uniform", "delta_budget"])
def test_quantized_engine_matches_sequential_on_its_own_draws(weights, plan):
    """Without injected draws (the port's seeded generator): engine ≡
    sequential, token for token, with requests joining mid-stream."""
    _, tparams = weights
    _, tcomp = _comps(plan)
    reqs = _requests(6, np.random.default_rng(8), 4, Request)
    eng = Engine(TCFG, SCFG, tparams, compression=tcomp, seed=3)
    for r in reqs[:3]:
        eng.submit(r)
    for r in reqs[3:]:
        eng.step()
        eng.submit(r)
    while not eng.idle:
        eng.step()
    seq = SequentialGenerator(TCFG, SCFG, tparams, compression=tcomp, seed=3)
    for r in reqs:
        assert seq.generate(list(r.prompt), r.max_new, rid=r.rid) \
            == eng.outputs[r.rid], r.rid


def test_quantized_restart_bit_exact_and_close_to_f32(weights):
    """tests/test_serve.py's contract: a restart with the same seed decodes
    bit-identically from a bit-identical payload, the payload is under a
    third of f32, and 8-bit weights move a prefill's logits by under 0.15
    of the largest |logit|."""
    _, tparams = weights
    _, tcomp = _comps("uniform")
    reqs = _requests(3, np.random.default_rng(6), 5, Request)
    e1 = Engine(TCFG, SCFG, tparams, compression=tcomp, seed=9)
    o1 = e1.run(reqs)
    e2 = Engine(TCFG, SCFG, tparams, compression=tcomp, seed=9)
    o2 = e2.run(reqs)
    assert o1 == o2
    for k, entry in e1.weights.stored.items():
        for f, x in entry.items():
            assert torch.equal(x, e2.weights.stored[k][f]), (k, f)
    meta = e1.weights.meta
    assert "8b" in e1.stats()["weights"]
    assert meta.payload_bytes < meta.f32_bytes / 3

    deq = dequantize_weights(meta, e1.weights.stored)
    toks = torch.tensor([reqs[0].prompt[:8]])
    lg_q, _ = TM.prefill(deq, TCFG, toks)
    lg_f, _ = TM.prefill(tparams, TCFG, toks)
    err = float((lg_q - lg_f).abs().max() / (lg_f.abs().max() + 1e-9))
    assert err < 0.15, f"8-bit weight logits drifted {err:.3f} from f32"


def test_serve_cli_quantized_on_the_cpu(capsys):
    """The CLI with --quantize-weights on the CPU: the same tokens as the
    engine built from the same seed, and the payload in the row."""
    argv = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--batch",
            "3", "--prompt-len", "16", "--gen", "4", "--quantize-weights",
            "qsgd8_linf", "--weight-plan", "delta_budget",
            "--weight-budget-mb", "1.0"]
    res = tserve.main(argv)
    row = res["row"]
    assert row["generated"] == 12 and row["mode"] == "engine"
    assert row["weights"].startswith("weights[3 buckets ")
    assert "8bx" not in row["weights"]          # the budget cut every bucket
    assert row["load_s"] > 0
    seq = tserve.main(argv + ["--sequential"])
    assert seq["outputs"] == res["outputs"]
    assert seq["row"]["weights"] == row["weights"]
    assert capsys.readouterr().out.count('"tokens_per_s"') == 2


def test_quantized_bfloat16_serving(weights):
    """bfloat16 weights: the rebuilt leaves are bfloat16, and the engine
    and the sequential baseline agree."""
    jparams, _ = weights
    tparams = params_from_jax(jax.device_get(
        jax.tree.map(lambda w: w.astype(jnp.bfloat16), jparams)))
    cfg = dataclasses.replace(TCFG, param_dtype="bfloat16")
    _, tcomp = _comps("uniform")
    reqs = _requests(3, np.random.default_rng(2), 3, Request)
    eng = Engine(cfg, SCFG, tparams, compression=tcomp, seed=1)
    out = eng.run(reqs)
    assert all(x.dtype == torch.bfloat16
               for x in T.leaves(eng.weights.params()))
    seq = SequentialGenerator(cfg, SCFG, tparams, compression=tcomp, seed=1)
    for r in reqs:
        assert seq.generate(list(r.prompt), r.max_new, rid=r.rid) \
            == out[r.rid]
    assert eng.weights.stored["b0"]["scales"].dtype == torch.float32
