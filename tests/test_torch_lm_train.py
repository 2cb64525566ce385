"""Port parity of LM training: the token stream, `_xent`, `chunked_xent`,
`loss_fn` and its gradients, remat, the model bundle and the trainer on
an LM, against `repro` on the CPU. The archs are `reduced()` (2 layers,
d_model 256, vocab 512), the JAX weights carried across by
`convert.params_from_jax` after a numpy-seeded nudge off their init scale,
the tokens numpy draws on both sides.

Tolerances:
  * float32: the loss and the aux losses to rtol 1e-5; each gradient leaf
    within 1e-5 of the tree's largest |g| (both sides compute in float32,
    sums run in other orders: ~1.5e-6 seen).
  * bfloat16 loss and aux losses: within two bfloat16 ulps of the
    reference's largest |value|, `test_bfloat16_prefill_and_decode_logits`'
    rule. bfloat16 gradients: each leaf's distance to the float32
    gradients at most 2.5 times the reference's own (XLA fuses the scan
    body and rounds to bfloat16 only at a fusion's edge, PyTorch rounds
    every op, so both land a few ulps from the float32 gradients, on
    different elements; the port's distance is 1.03-1.98 times JAX's
    across the seven archs).
  * remat on and off: bit for bit (the same ops, recomputed).
  * the DQGAN trajectory: `test_torch_dqgan.py`'s rules.
"""
import dataclasses
import functools
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
from repro.models import model as JM
from repro.models import registry as JR
from repro.strategy import Compression as JComp
from repro.strategy import Strategy as JStrategy
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.convert import params_from_jax
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.data import synthetic as TD
from repro_torch.models import build
from repro_torch.models import model as TM
from repro_torch.models import registry as TR
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import one_thread  # noqa: F401 (autouse)

ARCHS = ["gemma-2b", "starcoder2-7b", "yi-34b", "chameleon-34b",
         "command-r-plus-104b", "qwen3-moe-30b-a3b", "arctic-480b",
         "mamba2-1.3b", "recurrentgemma-2b", "whisper-tiny"]
B, S = 2, 16


def _cfgs(arch, **changes):
    return tuple(dataclasses.replace(get(arch).reduced(), **changes)
                 for get in (jcfgs.get, tcfgs.get))


def _params(jc, seed=0):
    """JAX params of `jc`, nudged by numpy draws (biases off zero, norm
    scales off one) and rounded to bfloat16 values (so that the float32
    and bfloat16 cases share their weights), and their port copy."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda w: (w.astype(jnp.float32) + 0.02 * rs.randn(*w.shape)
                   .astype(np.float32)).astype(jnp.bfloat16).astype(w.dtype),
        JM.init(jax.random.key(seed), jc, S))
    return params, params_from_jax(jax.device_get(params))


def _batch(vocab, seed=1, b=B, s=S, enc_shape=None):
    """Numpy tokens and targets, and an encoder-decoder model's encoder
    inputs (b,) + enc_shape, for both packages."""
    rs = np.random.RandomState(seed)
    toks, tgts = (rs.randint(0, vocab, (b, s)) for _ in range(2))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "targets": jnp.asarray(tgts, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(tgts).long()}
    if enc_shape is not None:
        e = (0.1 * rs.randn(b, *enc_shape)).astype(np.float32)
        jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(e), torch.tensor(e)
    return jb, tb


def _jax_loss_and_grads(params, jc, jbatch):
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jc, b), has_aux=True))(params, jbatch)
    return float(total), jax.device_get(metrics), jax.device_get(grads)


@functools.lru_cache(maxsize=None)
def _case(arch, dtype="float32", changes=()):
    """(port config, port params, port batch, JAX total, metrics, grads)
    of `arch` reduced with `changes`, at `dtype` (cached: the bfloat16
    case compares against the float32 case's gradients)."""
    jc, tc = _cfgs(arch, param_dtype=dtype, **dict(changes))
    params, tparams = _params(jc)
    jbatch, tbatch = _batch(jc.vocab_size, enc_shape=(
        (jc.encdec.enc_seq, jc.d_model) if jc.is_encdec else None))
    return (tc, tparams, tbatch) + _jax_loss_and_grads(params, jc, jbatch)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab", [512, 49_152])
def test_lm_tokens_equal_synthetic_lm_batch_on_jax_draws(vocab):
    """`lm_tokens` on the draws `synthetic_lm_batch` makes from its key
    gives its batch, token for token, as int64."""
    key = jax.random.key(11)
    want = JD.synthetic_lm_batch(key, 4, 32, vocab)
    k1, k2 = jax.random.split(key)
    start = np.asarray(jax.random.randint(k1, (4, 1), 0, vocab))
    chose = np.asarray(jax.random.randint(k2, (4, 32), 0, 4))
    got = TD.lm_tokens(torch.tensor(start), torch.tensor(chose), vocab)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_lm_batch_iterator_draws_from_its_generator():
    g = torch.Generator().manual_seed(3)
    it = TD.lm_batch_iterator(4, 16, 512, generator=g)
    a, b = next(it), next(it)
    assert a["tokens"].shape == a["targets"].shape == (4, 16)
    assert a["tokens"].dtype == torch.int64
    assert not torch.equal(a["tokens"], b["tokens"])
    # targets are the tokens shifted by one, each a preferred offset on
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    step = (a["targets"] - a["tokens"]) % 512
    assert set(step.unique().tolist()) <= set(TD.LM_OFFSETS)
    again = TD.lm_batch_iterator(4, 16, 512,
                                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(next(again)["tokens"], a["tokens"])
    # with encoder inputs: drawn after the tokens, which stay the same
    enc = next(TD.lm_batch_iterator(4, 16, 512, enc_shape=(8, 16),
                                    generator=torch.Generator().manual_seed(3)))
    assert enc["enc_embeds"].shape == (4, 8, 16)
    assert torch.equal(enc["tokens"], a["tokens"])


# --------------------------------------------------------------------------- #
# cross-entropy
# --------------------------------------------------------------------------- #
def test_xent_matches():
    rs = np.random.RandomState(2)
    logits = (4 * rs.randn(3, 7, 64)).astype(np.float32)
    tg = rs.randint(0, 64, (3, 7))
    np.testing.assert_allclose(
        TM._xent(torch.from_numpy(logits), torch.from_numpy(tg)).numpy(),
        np.asarray(JM._xent(jnp.asarray(logits), jnp.asarray(tg))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "command-r-plus-104b"])
def test_chunked_xent_matches(arch):
    """xent_chunk 8 over S 16: two chunks, totals summed in float32 and
    divided once by B·S; values and gradients to float32 rounding (the
    tied embedding of command-r-plus takes the logits' gradient too)."""
    jc, tc = _cfgs(arch)
    params, tparams = _params(jc)
    rs = np.random.RandomState(3)
    hidden = rs.randn(B, S, jc.d_model).astype(np.float32)
    tg = rs.randint(0, jc.vocab_size, (B, S))

    def jloss(p, h):
        return JM.chunked_xent(p, jc, h, jnp.asarray(tg), 8)

    want, (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_()
    paths, leaves = T.flatten(tparams)
    leaves = [x.requires_grad_() for x in leaves]
    got = TM.chunked_xent(T.unflatten(paths, leaves), tc, h,
                          torch.from_numpy(tg), 8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    full = TM._xent(TM.logits_fn(tparams, tc, h), torch.from_numpy(tg))
    np.testing.assert_allclose(got.item(), full.mean().item(), rtol=1e-6)
    grads = torch.autograd.grad(got, [h] + leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgh)).max())
    jl = T.flatten_up_to(paths, jax.device_get(jgp))
    gmax = max(np.abs(np.asarray(x)).max() for x in jl)
    for path, a, b in zip(paths, jl, grads[1:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5 * gmax, err_msg=T.keystr(path))
    with pytest.raises(ValueError, match="multiple"):
        TM.chunked_xent(tparams, tc, h[:, :12], torch.from_numpy(tg)[:, :12],
                        8)


# --------------------------------------------------------------------------- #
# loss_fn and its gradients
# --------------------------------------------------------------------------- #
def _check_f32(arch, **changes):
    tc, tparams, tbatch, jtotal, jm, jg = _case(
        arch, changes=tuple(sorted(changes.items())))
    tg, tm = build(tc).field_fn(tparams, tbatch)
    # the total is the loss plus the aux losses
    np.testing.assert_allclose(float(sum(tm.values())), jtotal, rtol=1e-5)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    paths, jl = T.flatten(jg)
    tl = T.flatten_up_to(paths, tg)
    assert [T.keystr(p) for p in T.flatten(tg)[0]] == [T.keystr(p)
                                                       for p in paths]
    gmax = max(np.abs(x).max() for x in jl)
    for path, a, b in zip(paths, jl, tl):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * gmax,
                                   err_msg=T.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_float32(arch):
    _check_f32(arch)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "yi-34b"])
def test_loss_and_grads_match_gqa(arch):
    """`reduced()` keeps 4 heads over 4 KV heads; with 2 KV heads each
    serves two query heads, as the full archs' GQA does."""
    _check_f32(arch, num_kv_heads=2)


def test_loss_fn_takes_the_chunked_path_when_the_chunk_divides_s():
    """xent_chunk 8 divides S 16: chunked; 12 does not: the plain mean."""
    for chunk in (8, 12):
        _check_f32("starcoder2-7b", xent_chunk=chunk)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_bfloat16(arch):
    tc, tparams, tbatch, _, jm, jg = _case(arch, "bfloat16")
    tg, tm = build(tc).field_fn(tparams, tbatch)
    for k in jm:
        want = float(jm[k])
        np.testing.assert_allclose(float(tm[k]), want, rtol=0,
                                   atol=2 * _bf16_ulp(abs(want)))
    # the float32 gradients at the same (bfloat16-valued) weights
    jg32 = _case(arch)[-1]
    paths, jl = T.flatten(jg)
    for path, a, b, ref in zip(paths, jl, T.flatten_up_to(paths, tg),
                               T.flatten_up_to(paths, jg32)):
        # the MoE router is float32 in a bfloat16 model, as in JAX
        assert str(b.dtype)[6:] == str(a.dtype), T.keystr(path)
        ref = _f32(ref)
        ours = np.abs(_f32(b) - ref).max()
        theirs = np.abs(_f32(a) - ref).max()
        assert ours <= 2.5 * theirs, (T.keystr(path), ours, theirs)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen3-moe-30b-a3b"])
def test_remat_on_equals_off_bit_for_bit(arch):
    """`torch.utils.checkpoint` around each period changes memory, not
    the numbers: loss, aux and every gradient bit-equal."""
    out = {}
    for remat in ("full", "none"):
        _, tc = _cfgs(arch, remat=remat)
        _, tparams = _params(_cfgs(arch)[0])
        out[remat] = build(tc).field_fn(tparams,
                                        _batch(tc.vocab_size)[1])
    (ga, ma), (gb, mb) = out["full"], out["none"]
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for a, b in zip(T.leaves(ga), T.leaves(gb)):
        assert torch.equal(a, b)


def test_grads_land_on_the_stacked_leaves():
    """The per-layer views' gradients reach the stacked leaves: layer i's
    slice of a stacked gradient is the gradient of an unscanned model's
    layer i (the same weights as a list under "tail")."""
    jc, tc = _cfgs("qwen3-moe-30b-a3b")
    _, tparams = _params(jc)
    tbatch = _batch(tc.vocab_size)[1]
    g_scan, _ = build(tc).field_fn(tparams, tbatch)
    flat = dict(tparams)
    flat["tail"] = [T.tree_map(lambda a, i=i: a[i].clone(),
                               tparams["scan"]["b0"]) for i in range(2)]
    del flat["scan"]
    tc_flat = dataclasses.replace(tc, scan_layers=False)
    g_tail, _ = build(tc_flat).field_fn(flat, tbatch)
    for i in range(2):
        for a, b in zip(T.leaves(g_tail["tail"][i]),
                        T.leaves(g_scan["scan"]["b0"])):
            torch.testing.assert_close(a, b[i], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# the bundle and the trainer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["dcgan32", "starcoder2-7b",
                                  "qwen3-moe-30b-a3b"])
def test_build_gives_the_jax_bundle_fields(arch):
    jb = JR.build(jcfgs.get(arch))
    tb = TR.build(tcfgs.get(arch))
    fields = [f for f in JR.ModelBundle.__dataclass_fields__]
    assert fields == list(TR.ModelBundle.__dataclass_fields__)
    for f in fields:
        assert (getattr(tb, f) is None) == (getattr(jb, f) is None), f
    # a GAN field draws its latent ahead of the exchange; an LM's draws
    # nothing
    assert hasattr(tb.field_fn, "draw_z") == (arch == "dcgan32")


def _draws(jtr, params, key, step):
    """The port's `draws` for one step: the uniform draws the JAX step
    makes for each bucket from `fold_in(kq, 100_000 + bid)` (an LM field
    draws nothing)."""
    _, kq = jax.random.split(jax.random.fold_in(key, step))
    layout, _ = jtr._comm(params)
    return {"rand": {b.bid: torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(kq, 100_000 + b.bid), (b.size,))))
        for b in layout.buckets}}


def test_three_step_dqgan_trajectory_matches():
    """Reduced starcoder2 under omd, qsgd8_block1024 over uniform buckets
    (B1's plain version, one packed call a step), JAX's draws replayed:
    params − e1 to rtol 1e-4 of the largest parameter, params within one
    quantization step, at most 1e-3 of the residuals flipped."""
    jc, tc = _cfgs("starcoder2-7b")
    jstrat = JStrategy(compression=JComp(compressor="qsgd8_block1024",
                                         plan="uniform", bucket_mb=1.0))
    kw = dict(optimizer="omd", lr=1e-2, message="update")
    jtr = JDQGAN(field_fn=JR.build(jc).field_fn,
                 dq=JDQ.from_strategy(jstrat, **kw))
    ttr = TDQGAN(field_fn=TR.build(tc).field_fn,
                 dq=TDQ.from_strategy(TStrategy.from_json(jstrat.to_json()),
                                      **kw), device="cpu")
    params, tparams = _params(jc)
    jst, tst = jtr.init(params), ttr.init(tparams)
    assert len(jtr._comm(params)[0].buckets) > 1
    step = jax.jit(jtr.step)
    key = jax.random.key(42)
    for t in range(3):
        batch = JD.synthetic_lm_batch(jax.random.key(100 + t), 4, S,
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


LM_FLAGS = ["--arch", "starcoder2-7b", "--smoke", "--seq", "16", "--steps",
            "3", "--optimizer", "omd", "--compressor", "qsgd8_block1024",
            "--comm-plan", "uniform", "--log-every", "1"]


def _rows(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_cli_trains_an_lm_with_the_jax_clis_wire_numbers():
    """`--device cpu --smoke --seq 16` on starcoder2: three finite rows,
    whose wire_mb_step and comm_ratio equal the JAX CLI's for the same
    flags."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = ttrain.main(LM_FLAGS + ["--device", "cpu"])
    rows = _rows(buf.getvalue())
    assert rows == hist and len(rows) == 3
    assert all(np.isfinite(r["loss"]) and r["step_s"] > 0 for r in rows)
    assert "# comm: 3 buckets (1842176 elems" in buf.getvalue()
    buf = io.StringIO()
    with redirect_stdout(buf):
        jtrain.main(LM_FLAGS)
    jrows = _rows(buf.getvalue())
    assert len(jrows) == 3
    for a, b in zip(rows, jrows):
        for k in ("wire_mb_step", "cum_wire_mb", "comm_ratio"):
            assert a[k] == b[k], k


def test_cli_trains_moe_over_four_workers():
    """qwen3-moe reduced, four stacked workers, half reporting, the
    adaptive family (B2's plain version): rows with 2 participants."""
    from repro_torch.launch import train as ttrain
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = ttrain.main([
            "--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
            "--seq", "16", "--steps", "2", "--workers", "4", "--batch", "8",
            "--optimizer", "omd", "--compressor", "qsgd8_block1024",
            "--comm-plan", "delta_budget", "--comm-budget-mb", "1.0",
            "--comm-adaptive", "--participation", "0.5"])
    assert "family[4]" in buf.getvalue()
    assert len(hist) == 2
    assert all(r["participants"] == 2 and np.isfinite(r["loss"])
               for r in hist)


def test_cli_without_a_gpu_refuses_an_lm_instead_of_falling_back(capsys):
    """The default device is cuda: with no card the LM run exits with an
    error naming --device cpu, and trains nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit) as e:
        ttrain.main(LM_FLAGS)
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "--device cpu" in out.err and not out.out.strip()
