"""Port parity of the SSD and RG-LRU mixers (`repro_torch.models.mixers`)
and of the archs built on them, mamba2-1.3b and recurrentgemma-2b, against
`repro` on the CPU: the causal conv and its decode step, the mixers over
a full sequence and as decode steps, the scan, prefill + decode through
`model`, the serving engine's state lanes, a DQGAN trajectory and the
trainer's CLI. The archs are `reduced()` (d_model 256; mamba2: 32 SSD
heads of 16 channels, state 16, chunk 32; recurrentgemma: width 256,
window 32, 3 layers, or 5 with the unscanned tail), the JAX weights
carried across by `convert.params_from_jax` after a numpy-seeded nudge,
the inputs numpy draws on both sides.

Tolerances:
  * float32 outputs and states: within 1e-5 of the reference's largest
    |value| (both sides in float32, sums in other orders; up to ~4e-6
    seen). The scan against `jax.lax.associative_scan`: 2e-6 of the
    largest |h| (XLA contracts the combine into FMAs; 4.8e-7 seen).
  * bfloat16 mixer outputs: within two bfloat16 ulps of the reference's
    largest |y|, the rule of `test_torch_lm.py`'s bfloat16 logits.
  * the chunk-256 against the chunk-32 SSD gradients: 1e-4 of each
    leaf's largest |g| (the same function, its sums grouped by chunk).
  * greedy tokens: equal.
  * the DQGAN trajectory: `test_torch_dqgan.py`'s rules.
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
from repro.configs.base import DQConfig as JDQ
from repro.core.dqgan import DQGAN as JDQGAN
from repro.data import synthetic as JD
from repro.models import mixers as JX
from repro.models import model as JM
from repro.models import registry as JR
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import init_paged_cache as j_init_paged_cache
from repro.strategy import Compression as JComp
from repro.strategy import Strategy as JStrategy
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.convert import params_from_jax
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import mixers as TX
from repro_torch.models import model as TM
from repro_torch.models import registry as TR
from repro_torch.serve import (Engine, Request, SequentialGenerator,
                               ServeConfig, init_paged_cache)
from repro_torch.strategy import Strategy as TStrategy
from test_torch_lm_train import _draws
from torch_ranks import one_thread  # noqa: F401 (autouse)

MIXERS = {"ssd": ("mamba2-1.3b", JX.ssd_init, JX.ssd_apply, TX.ssd_apply),
          "rglru": ("recurrentgemma-2b", JX.rglru_init, JX.rglru_apply,
                    TX.rglru_apply)}


def _cfgs(arch, **changes):
    return tuple(dataclasses.replace(get(arch).reduced(), **changes)
                 for get in (jcfgs.get, tcfgs.get))


def _nudge(tree, seed, scale=0.05):
    """Every leaf moved off its init by numpy draws (zeros and ones
    included), in its own dtype; and the port's copy."""
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda w: (w.astype(jnp.float32) + scale * rs.randn(*w.shape)
                   .astype(np.float32)).astype(w.dtype), tree)
    return tree, params_from_jax(jax.device_get(tree))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32), np.float32)


def _close(got, want, rel=1e-5, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _mixer(kind, dtype="float32", seed=0, **changes):
    arch, init, _, _ = MIXERS[kind]
    jc, tc = _cfgs(arch, param_dtype=dtype, **changes)
    p, tp = _nudge(init(jax.random.key(seed), jc, jnp.dtype(dtype)), seed)
    return jc, tc, p, tp


# --------------------------------------------------------------------------- #
# the causal conv
# --------------------------------------------------------------------------- #
def test_causal_conv1d_and_conv_step():
    """The full-sequence conv, and a decode step from the buffer of the
    inputs before it, equal the reference's; the step's output is the
    full conv's row at that position."""
    p, tp = _nudge(JX.conv1d_init(jax.random.key(3), 24, 4, jnp.float32), 3)
    x = np.random.RandomState(4).randn(2, 9, 24).astype(np.float32)
    want = JX.causal_conv1d(p, jnp.asarray(x))
    got = TX.causal_conv1d(tp, torch.from_numpy(x))
    _close(got, want, what="causal_conv1d")
    buf, xt = x[:, 5:8], x[:, 8:9]
    oj, bj = JX.conv_step(p, jnp.asarray(buf), jnp.asarray(xt))
    ot, bt = TX.conv_step(tp, torch.from_numpy(buf), torch.from_numpy(xt))
    _close(ot, oj, what="conv_step")
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    _close(ot[:, 0], got[:, 8], what="step vs full")


# --------------------------------------------------------------------------- #
# the scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T_", [1, 2, 64, 77])
def test_associative_scan_matches_jax(T_):
    """`associative_scan` against `jax.lax.associative_scan` with the
    RG-LRU's combine, and both against the recurrence run in float64, on
    odd, even and length-1 sequences."""
    rs = np.random.RandomState(T_)
    a = rs.uniform(0.5, 1.0, (2, T_, 16)).astype(np.float32)
    b = rs.randn(2, T_, 16).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    wa, wh = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    ga, gh = TX.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(gh, wh, rel=2e-6, what="h")
    _close(ga, wa, rel=2e-6, what="a")
    h, ref = np.zeros((2, 16)), []
    for t in range(T_):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        ref.append(h)
    _close(gh, np.stack(ref, 1).astype(np.float32), rel=2e-6, what="loop")


# --------------------------------------------------------------------------- #
# the mixers over a full sequence, and their decode steps
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_mixer_full_sequence_and_prefill_state(kind, dtype):
    """64 tokens (two SSD chunks): the output and the state prefill
    returns (the final h in float32, the conv buffer in the model's
    dtype); f32 leaves (A_log, lam) stay f32 in a bfloat16 tree."""
    _, _, japply, tapply = MIXERS[kind]
    jc, tc, p, tp = _mixer(kind, dtype)
    f32_leaf = {"ssd": "A_log", "rglru": "lam"}[kind]
    assert tp[f32_leaf].dtype == torch.float32
    x = np.random.RandomState(5).randn(2, 64, jc.d_model).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    yj, sj = jax.jit(lambda p, x: japply(p, jc, x, return_state=True))(p, xj)
    xt = torch.tensor(_f32(xj)).to(getattr(torch, dtype))
    yt, st = tapply(tp, tc, xt, return_state=True)
    assert yt.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(yt, yj, what="y")
        for k in ("h", "conv"):
            _close(st[k], sj[k], what=k)
    else:
        want = _f32(yj)
        np.testing.assert_allclose(_f32(yt), want, rtol=0,
                                   atol=2 * _bf16_ulp(np.abs(want).max()))
    for k in ("h", "conv"):
        assert str(st[k].dtype)[6:] == str(sj[k].dtype), k


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_mixer_decode_steps_update_the_state_in_place(kind):
    """Prefill 32 tokens, then 3 decode tokens: each step's output and
    state equal the reference's, the new state lands in the tensors
    passed in (the same dict back), and the steps' outputs equal the full
    sequence's last 3 rows."""
    _, _, japply, tapply = MIXERS[kind]
    jc, tc, p, tp = _mixer(kind, seed=1)
    x = np.random.RandomState(6).randn(2, 35, jc.d_model).astype(np.float32)
    _, sj = japply(p, jc, jnp.asarray(x[:, :32]), return_state=True)
    _, st = tapply(tp, tc, torch.from_numpy(x[:, :32]), return_state=True)
    ys = []
    for t in range(32, 35):
        h_before = st["h"]
        yj, sj = japply(p, jc, jnp.asarray(x[:, t:t + 1]), state=sj)
        yt, st2 = tapply(tp, tc, torch.from_numpy(x[:, t:t + 1]), state=st)
        assert st2 is st and st["h"] is h_before
        _close(yt, yj, what=f"y {t}")
        for k in ("h", "conv"):
            _close(st[k], sj[k], what=f"{k} {t}")
        ys.append(yt)
    cfg = tc
    if kind == "ssd":   # a chunk size that divides 35 tokens
        cfg = dataclasses.replace(tc, ssm=dataclasses.replace(
            tc.ssm, chunk_size=7))
    full, _ = tapply(tp, cfg, torch.from_numpy(x))
    _close(torch.cat(ys, 1), full[:, 32:], what="decode vs full")


def test_ssd_chunk_256_gradients_are_finite_and_equal_chunk_32():
    """C4. The reference's SSD takes exp(cum_l - cum_m) before its tril
    mask (`repro/models/mixers.py:139-141`); at mamba2's published chunk
    size 256 the masked exponents overflow to inf and its backward forms
    0 * inf: the JAX gradients of A_log, dt and dt_bias are not finite
    there (asserted below, as the record of the defect). The port masks
    the exponent first: at chunk 256 over 256 tokens its forward equals
    the reference's, its gradients are finite and equal its own at chunk
    32 (the chunked SSD computes one function for every chunk size)."""
    jc, tc, p, tp = _mixer("ssd", seed=2, ssm=dataclasses.replace(
        jcfgs.get("mamba2-1.3b").reduced().ssm, chunk_size=256))
    x = np.random.RandomState(7).randn(1, 256, jc.d_model).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JX.ssd_apply(p, jc, x)[0] ** 2)

    yj = JX.ssd_apply(p, jc, jnp.asarray(x))[0]
    gj = jax.jit(jax.grad(jloss))(p, jnp.asarray(x))
    assert not all(np.isfinite(np.asarray(gj[k])).all()
                   for k in ("A_log", "dt_bias"))

    def grads(cfg):
        paths, leaves = T.flatten(tp)
        leaves = [w.detach().clone().requires_grad_() for w in leaves]
        y = TX.ssd_apply(T.unflatten(paths, leaves), cfg,
                         torch.from_numpy(x))[0]
        g = torch.autograd.grad((y ** 2).sum(), leaves)
        return y.detach(), dict(zip([T.keystr(q) for q in paths], g))

    y256, g256 = grads(tc)
    y32, g32 = grads(dataclasses.replace(tc, ssm=dataclasses.replace(
        tc.ssm, chunk_size=32)))
    _close(y256, yj, what="forward at chunk 256")
    _close(y32, yj, what="forward at chunk 32")
    for k in g256:
        assert torch.isfinite(g256[k]).all(), k
        _close(g256[k], g32[k], rel=1e-4, what=k)
    assert g256["['A_log']"].abs().max() > 0


# --------------------------------------------------------------------------- #
# the archs: prefill + decode through the model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,layers,prompt", [
    ("mamba2-1.3b", 2, 64), ("recurrentgemma-2b", 3, 48),
    ("recurrentgemma-2b", 5, 48)])
def test_prefill_and_decode_match_jax(arch, layers, prompt):
    """`model.prefill` over the prompt, then 3 teacher-forced decode
    steps: logits and every cache leaf (SSD/RG-LRU states, recurrentgemma's
    rolling window K/V past its 32-slot window) equal the reference's.
    recurrentgemma at 5 layers runs one scanned period and the unscanned
    tail of two RG-LRU layers, the full model's layout."""
    jc, tc = _cfgs(arch, num_layers=layers)
    params, tparams = _nudge(JM.init(jax.random.key(0), jc, 0), 0, 0.02)
    if layers == 5:
        assert len(tparams["tail"]) == 2 and "scan" in tparams
    rs = np.random.RandomState(8)
    toks = rs.randint(1, jc.vocab_size, (2, prompt + 3))
    lj, cj = jax.jit(lambda p, t: JM.prefill(p, jc, t))(
        params, jnp.asarray(toks[:, :prompt], jnp.int32))
    lt, ct = TM.prefill(tparams, tc, torch.from_numpy(toks[:, :prompt]))
    _close(lt, lj, what="prefill logits")
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jc, t, c))
    for t in range(prompt, prompt + 3):
        lj, cj = step(params, jnp.asarray(toks[:, t:t + 1], jnp.int32), cj)
        lt, ct = TM.decode_step(tparams, tc, torch.from_numpy(
            toks[:, t:t + 1]), ct)
        _close(lt, lj, what=f"logits {t}")
    paths, jl = T.flatten(jax.device_get(cj))
    tl = T.flatten_up_to(paths, ct)
    assert len(tl) == len(jl) > 0
    for path, a, b in zip(paths, jl, tl):
        _close(b, a, what=T.keystr(path))


def test_init_and_cache_trees_match_jax():
    """init and init_cache give the reference's trees: paths, shapes and
    dtypes, bfloat16 with the f32 leaves A_log and lam."""
    for arch, layers in (("mamba2-1.3b", 2), ("recurrentgemma-2b", 5)):
        jc, tc = _cfgs(arch, num_layers=layers, param_dtype="bfloat16")
        for j, t in ((JM.init(jax.random.key(0), jc, 0),
                      TM.init(tc, generator=torch.Generator().manual_seed(0))),
                     (JM.init_cache(jc, 2, 16), TM.init_cache(tc, 2, 16))):
            jp, jl = T.flatten(jax.device_get(j))
            tp, tl = T.flatten(t)
            assert [T.keystr(p) for p in tp] == [T.keystr(p) for p in jp]
            for path, a, b in zip(jp, jl, tl):
                assert tuple(b.shape) == np.shape(a), T.keystr(path)
                assert str(b.dtype)[6:] == str(np.asarray(a).dtype), \
                    T.keystr(path)


# --------------------------------------------------------------------------- #
# serving: the engine's state lanes
# --------------------------------------------------------------------------- #
SCFG = ServeConfig(max_batch=4, block_size=8, num_blocks=64,
                   max_blocks_per_seq=8, prompt_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def mamba():
    jc, tc = _cfgs("mamba2-1.3b")
    params = JM.init(jax.random.key(0), jc, 0)
    return jc, tc, params, params_from_jax(jax.device_get(params))


def _requests(n, rng, cls, vocab):
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(
                1, vocab, int(rng.integers(3, 40)))],
                max_new=int(rng.integers(1, 8))) for i in range(n)]


def _run_churn(eng, reqs):
    """Three requests up front, the rest joining mid-stream while earlier
    ones decode and some have left (tests/test_serve.py's scenario)."""
    for r in reqs[:3]:
        eng.submit(r)
    for r in reqs[3:]:
        eng.step()
        eng.submit(r)
    while not eng.idle:
        assert eng.step()
    return eng.outputs


def test_paged_cache_has_the_jax_state_lanes(mamba):
    jc, tc, _, _ = mamba
    jp, jl = T.flatten(jax.device_get(j_init_paged_cache(jc, SCFG)))
    tp, tl = T.flatten(init_paged_cache(tc, SCFG))
    assert [T.keystr(p) for p in tp] == [T.keystr(p) for p in jp]
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape and b.shape[1] == SCFG.max_batch


def test_engine_matches_sequential_and_the_jax_engine_for_mamba2(mamba):
    """mamba2 reduced through the paged engine with mid-stream churn (7
    requests of 3-39 prompt tokens: prefilled at 8, 16 or 32, or claimed
    with a zero state below 8, their lanes reused): greedy tokens equal
    the port's sequential baseline and the JAX engine, and every block
    comes back."""
    jc, tc, params, tparams = mamba
    want = _run_churn(JEngine(jc, SCFG, params), _requests(
        7, np.random.default_rng(3), JRequest, jc.vocab_size))
    reqs = _requests(7, np.random.default_rng(3), Request, tc.vocab_size)
    assert any(len(r.prompt) < 8 for r in reqs)
    eng = Engine(tc, SCFG, tparams)
    out = _run_churn(eng, reqs)
    assert out == want
    assert eng.alloc.used_blocks == 0
    seq = SequentialGenerator(tc, SCFG, tparams)
    for r in reqs:
        assert seq.generate(list(r.prompt), r.max_new, rid=r.rid) \
            == out[r.rid], f"rid={r.rid} P={len(r.prompt)}"


def test_reused_slot_gets_a_zeroed_or_prefilled_state_lane(mamba):
    """A slot admitted without prefill (a prompt below the smallest
    bucket) has its state lanes zeroed over whatever a previous request
    left there; a prefilled slot's lanes hold the prefill's state; the
    other lanes are untouched."""
    _, tc, _, tparams = mamba
    eng = Engine(tc, SCFG, tparams)
    lanes = T.leaves(eng.cache)
    for x in lanes:
        x.fill_(7.0)
    eng.submit(Request(rid=0, prompt=[5, 6, 7], max_new=2))
    eng._try_admit()
    for x in lanes:                     # (layers, slots, ...)
        assert (x[:, 0] == 0).all() and (x[:, 1:] == 7).all()
    prompt = list(range(1, 17))
    eng.submit(Request(rid=1, prompt=prompt, max_new=2))
    eng._try_admit()
    _, pre = TM.prefill(tparams, tc, torch.tensor([prompt]))
    for a, b in zip(lanes, T.leaves({"scan": pre["scan"]})):
        assert torch.equal(a[:, 1], b[:, 0])
        assert (a[:, 2:] == 7).all()


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def test_three_step_dqgan_trajectory_matches_on_mamba2():
    """Reduced mamba2 under omd, qsgd8_block1024 over uniform buckets (B1's
    plain version, one packed call a step), JAX's draws replayed: params
    − e1 to rtol 1e-4 of the largest parameter, params within one
    quantization step, at most 1e-3 of the residuals flipped."""
    jc, tc = _cfgs("mamba2-1.3b")
    jstrat = JStrategy(compression=JComp(compressor="qsgd8_block1024",
                                         plan="uniform", bucket_mb=1.0))
    kw = dict(optimizer="omd", lr=1e-2, message="update")
    jtr = JDQGAN(field_fn=JR.build(jc).field_fn,
                 dq=JDQ.from_strategy(jstrat, **kw))
    ttr = TDQGAN(field_fn=TR.build(tc).field_fn,
                 dq=TDQ.from_strategy(TStrategy.from_json(jstrat.to_json()),
                                      **kw), device="cpu")
    params, tparams = _nudge(JM.init(jax.random.key(0), jc, 0), 0, 0.02)
    jst, tst = jtr.init(params), ttr.init(tparams)
    assert len(jtr._comm(params)[0].buckets) > 1
    step = jax.jit(jtr.step)
    key = jax.random.key(42)
    for t in range(3):
        batch = JD.synthetic_lm_batch(jax.random.key(100 + t), 4, 32,
                                      jc.vocab_size)
        tbatch = {k: torch.from_numpy(np.array(v)).long()
                  for k, v in batch.items()}
        jout = step(jst, batch, key)
        tout = ttr.step(tst, tbatch, _draws(jtr, params, key, t))
        jst, tst = jout.state, tout.state
        np.testing.assert_allclose(float(tout.metrics["loss"]),
                                   float(jout.metrics["loss"]), rtol=1e-5)
    jst = jax.device_get(jst)
    paths, jp = T.flatten(jst.params)
    tp = [x.numpy() for x in T.flatten_up_to(paths, tst.params)]
    je = [x["e1"][0] for x in T.flatten_up_to(paths, jst.ef["leaf"])]
    te = [x["e1"][0].numpy()
          for x in T.flatten_up_to(paths, tst.ef["leaf"])]
    scale = max(np.abs(x).max() for x in jp)
    emax = max(np.abs(x).max() for x in je)
    flips = sum(int((np.abs(a - b) > 1e-3 * emax).sum())
                for a, b in zip(je, te)) / sum(x.size for x in je)
    assert flips <= 1e-3, flips
    for a, b, x, y in zip(jp, tp, je, te):
        np.testing.assert_allclose(b - y, a - x, rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale + emax)


def _rows(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_cli_trains_with_the_jax_clis_wire_numbers(arch):
    """`--device cpu --smoke --seq 16`, 3 steps: finite rows whose
    wire_mb_step, cum_wire_mb and comm_ratio equal the JAX CLI's."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    flags = ["--arch", arch, "--smoke", "--seq", "16", "--steps", "3",
             "--optimizer", "omd", "--compressor", "qsgd8_block1024",
             "--comm-plan", "uniform", "--log-every", "1"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = ttrain.main(flags + ["--device", "cpu"])
    rows = _rows(buf.getvalue())
    assert rows == hist and len(rows) == 3
    assert all(np.isfinite(r["loss"]) and r["step_s"] > 0 for r in rows)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jtrain.main(flags)
    jrows = _rows(buf.getvalue())
    assert len(jrows) == 3
    for a, b in zip(rows, jrows):
        for k in ("wire_mb_step", "cum_wire_mb", "comm_ratio"):
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", [[], ["--sequential"]])
def test_serve_cli_serves_mamba2(mode):
    """The serving CLI on mamba2 reduced (`--device cpu --smoke`): the
    engine, or the sequential baseline, generates every token, with the
    same first request's tokens either way."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device",
                          "cpu", "--batch", "3", "--prompt-len", "20",
                          "--gen", "4"] + mode)
    row = _rows(buf.getvalue())[-1]
    assert row["arch"] == "mamba2-1.3b-smoke" and row["generated"] == 12
    assert row["mode"] == ("sequential" if mode else "engine")
    assert out["outputs"][0][:4] == row["sample_tokens"][:4]
