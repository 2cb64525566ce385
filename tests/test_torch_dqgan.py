"""Port parity: the single-worker DQGAN step of `repro_torch.core.dqgan`
against `repro.core.dqgan.DQGAN.step` over 5 steps, on the reduced dcgan32
config, with converted weights and the JAX package's draws replayed into
the port (its key derivation: `split(fold_in(key, step))` into the field's
key and the quantizer's, `fold_in(kq, leaf index)` per leaf and
`fold_in(kq, 100_000 + bucket id)` per bucket).

What is compared, and how tightly:
  * params − e1: EF keeps p̂ + e' = m, so w' − e' = w − m whatever the
    codes did; it drifts only with the float32 rounding of the two
    frameworks' convolutions (rtol 1e-4 of the largest parameter).
  * params: within a few quantization steps, since a code flipped at a
    rounding boundary moves one element by one step s/L (and feeds back).
  * the fraction of elements whose residual differs by more than rounding
    (a flipped code): at most 1e-3.
  * without quantization (CPOAdam), or without EF: params and Adam state
    to float32 rounding grown over 5 steps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import DQConfig as JDQ
from repro.core import compressors as JC
from repro.core import error_feedback as JEF
from repro.core.dqgan import DQGAN as JDQGAN
from repro.data import synthetic as JD
from repro.models import gan as JG
from repro.strategy import Compression as JComp
from repro.strategy import ExchangePlan as JEx
from repro.strategy import Strategy as JStrategy
from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.convert import params_from_jax
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import gan as TG
from repro_torch.strategy import Strategy as TStrategy

CFG = jget("dcgan32").reduced()
TCFG = TG.GANConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
B, STEPS = 8, 5

# name: (compression, exchange kind, optimizer, extrapolation, lr)
RUNS = {
    "dqgan_per_leaf": (dict(compressor="qsgd8_linf"), "sim", "omd",
                       "local", 1e-2),
    "dqgan_bucketed": (dict(compressor="qsgd8_block1024", plan="uniform",
                            bucket_mb=0.02), "sim", "omd", "local", 1e-2),
    "dqgan_block1024_per_leaf": (dict(compressor="qsgd8_block1024"), "sim",
                                 "omd", "local", 1e-2),
    "dqgan_global_extrapolation": (dict(compressor="qsgd8_linf"), "sim",
                                   "omd", "global", 1e-2),
    "dqgan_two_phase_size_tiered": (dict(compressor="qsgd8_block1024",
                                         plan="size_tiered",
                                         bucket_mb=0.02),
                                    "two_phase", "omd", "local", 1e-2),
    "dqgan_byte_budget": (dict(compressor="qsgd8_linf", plan="delta_budget",
                               bucket_mb=0.02, budget_mb=0.01),
                          "two_phase", "omd", "local", 1e-2),
    "cpoadam": (dict(compressor="identity", error_feedback=False), "exact",
                "oadam", "local", 1e-3),
    "cpoadam_gq": (dict(compressor="qsgd8_linf", error_feedback=False),
                   "sim", "oadam", "local", 1e-3),
    "adam_bucketed": (dict(compressor="qsgd8_block1024", plan="uniform",
                           bucket_mb=0.02), "sim", "adam", "local", 1e-3),
    "sgd_per_leaf": (dict(compressor="qsgd4_linf"), "sim", "sgd", "local",
                     1e-2),
}


def _draw(comp, shape, key, fused):
    d = math.prod(shape)
    if fused:
        return np.asarray(jax.random.uniform(key, (d,)))
    if isinstance(comp, JC.StochasticQuant):
        b = comp.per_block
        return np.asarray(jax.random.uniform(
            key, (1, d) if b <= 0 else (-(-d // b), b)))
    return None


def _replay_draws(jtr, params, key, step):
    """The port's `draws` for one step: what the JAX step draws from key."""
    kfield, kq = jax.random.split(jax.random.fold_in(key, step))
    draws = {"z": torch.from_numpy(np.array(
        jax.random.normal(kfield, (B, CFG.latent_dim)))), "rand": {}}
    use_ef = jtr.dq.error_feedback
    if jtr.bucketed:
        layout, cplan = jtr._comm(params)
        streams = [(b.bid, JC.get(a.compressor), (b.size,), 100_000 + b.bid)
                   for b, a in zip(layout.buckets, cplan.assignments)]
    else:
        streams = [(i, jtr.compressor, tuple(l.shape), i)
                   for i, l in enumerate(jax.tree.leaves(params))]
    for sid, comp, shape, fold in streams:
        sds = jax.ShapeDtypeStruct(shape, jnp.float32)
        fused = use_ef and JEF.fused_compatible(comp, sds)
        r = _draw(comp, shape, jax.random.fold_in(kq, fold), fused)
        if r is not None:
            draws["rand"][sid] = torch.from_numpy(np.array(r))
    return draws


def _trainers(name):
    """(JAX trainer, port trainer, JAX initial params) of run `name`."""
    comp_kw, kind, optim, extrap, lr = RUNS[name]
    jstrat = JStrategy(compression=JComp(**comp_kw), exchange=JEx(kind=kind))
    tstrat = TStrategy.from_json(jstrat.to_json())
    kw = dict(optimizer=optim, lr=lr, extrapolation=extrap,
              message="update" if optim == "omd" else "grad")
    jtr = JDQGAN(field_fn=JG.gan_field_fn(CFG),
                 dq=JDQ.from_strategy(jstrat, **kw))
    ttr = TDQGAN(field_fn=TG.gan_field_fn(TCFG),
                 dq=TDQ.from_strategy(tstrat, **kw), device="cpu")
    return jtr, ttr, JG.init(jax.random.key(0), CFG)


def _batch(t):
    return JD.procedural_images(jax.random.key(100 + t), B, CFG.image_size,
                                CFG.channels)


def _run_both(name):
    jtr, ttr, params = _trainers(name)
    jst = jtr.init(params)
    tst = ttr.init(params_from_jax(jax.device_get(params)))
    step = jax.jit(jtr.step)
    key = jax.random.key(42)
    for t in range(STEPS):
        real = _batch(t)
        draws = _replay_draws(jtr, params, key, t)
        jout = step(jst, {"real": real}, key)
        tout = ttr.step(tst, {"real": torch.from_numpy(np.array(real))},
                        draws)
        jst, tst = jout.state, tout.state
    return jtr, jax.device_get(jst), tst, jax.device_get(jout.metrics), \
        tout.metrics


def _leaves(tree, paths):
    return [np.asarray(x) for x in T.flatten_up_to(paths, tree)]


@pytest.mark.parametrize("name", list(RUNS))
def test_five_step_trajectory_matches(name):
    jtr, jst, tst, jm, tm = _run_both(name)
    paths, jp = T.flatten(jst.params)
    tp = [x.numpy() for x in T.flatten_up_to(paths, tst.params)]
    scale = max(np.abs(x).max() for x in jp)
    assert tst.step == int(jst.step) == STEPS
    quantized = jtr.compressor.name != "identity"
    # float32 rounding of the parameters
    tight = 1e-6 * scale
    if jtr.dq.error_feedback:
        jl = jst.ef["leaf"] if jtr.bucketed else jst.ef
        tl = tst.ef["leaf"] if jtr.bucketed else tst.ef
        je = [x["e1"][0] for x in T.flatten_up_to(paths, jl)]
        te = [x["e1"][0].numpy() for x in T.flatten_up_to(paths, tl)]
        emax = max(np.abs(x).max() for x in je)
        flips = sum(int((np.abs(a - b) > 1e-3 * emax).sum())
                    for a, b in zip(je, te)) / sum(x.size for x in je)
        assert flips <= 1e-3, flips
        # |e1| < one step s/L, so max|m| ≈ 127·max|e1|: e1 = m − q·s/L is
        # exact to float32 rounding of m (XLA may fuse it into an FMA)
        atol = tight + 1e-6 * 127 * emax
        for a, b, x, y in zip(jp, tp, je, te):
            np.testing.assert_allclose(b - y, a - x, rtol=0, atol=atol)
        # params: that, plus one quantization step for a flipped code
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b, a, rtol=0, atol=atol + emax)
    elif quantized:
        # no residual: a flipped code of CPOAdam-GQ moves an element's Adam
        # direction by at most ~2 (|d| ≤ ~1), i.e. ≤ 2·lr per step; all
        # other elements agree to rounding
        off = sum(int((np.abs(a - b) > tight).sum()) for a, b in zip(jp, tp))
        assert off / sum(x.size for x in jp) <= 1e-3
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=2 * jtr.dq.lr * STEPS)
    else:
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b, a, rtol=0, atol=tight)
    for k in ("m", "v", "prev_update"):
        if getattr(jst, k) is None:
            assert getattr(tst, k) is None
            continue
        ja = _leaves(getattr(jst, k), paths)
        ta = [x.numpy() for x in T.flatten_up_to(paths, getattr(tst, k))]
        mx = max(np.abs(x).max() for x in ja)
        # Adam's moments and direction: float32 rounding grown over 5
        # steps (2e-6 relative seen; 2e-5 allowed)
        for a, b in zip(ja, ta):
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-5 * mx)
    if jtr.bucketed and jtr.strategy.exchange.owner_ef:
        assert sorted(tst.ef["bucket"]) == sorted(jst.ef["bucket"])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)


def test_state_layout_matches():
    """Same DQState fields, per-worker leading axis of 1, same EF tree."""
    jstrat = JStrategy(compression=JComp(compressor="qsgd8_block1024",
                                         plan="uniform", bucket_mb=0.02),
                       exchange=JEx(kind="two_phase"))
    tstrat = TStrategy.from_json(jstrat.to_json())
    jtr = JDQGAN(field_fn=JG.gan_field_fn(CFG),
                 dq=JDQ.from_strategy(jstrat, optimizer="omd"))
    ttr = TDQGAN(field_fn=TG.gan_field_fn(TCFG),
                 dq=TDQ.from_strategy(tstrat, optimizer="omd"), device="cpu")
    params = JG.init(jax.random.key(0), CFG)
    jst = jtr.init(params)
    tst = ttr.init(params_from_jax(jax.device_get(params)))
    assert type(tst).__name__ == "DQState"
    assert tst._fields == jst._fields

    def shapes(tree):
        return sorted((T.keystr(p), tuple(x.shape))
                      for p, x in zip(*T.flatten(tree)) if x is not None)

    jshapes = jax.tree.map(lambda x: x, jax.device_get(jst.ef))
    assert shapes(tst.ef) == shapes(jshapes)
    assert shapes(tst.prev_grad) == shapes(jax.device_get(jst.prev_grad))
    lj = jtr.comm_ledger(params).summary()
    lt = ttr.comm_ledger(tst.params).summary()
    assert lt == lj


def _run_port(name, steps):
    """The port's trainer alone over `steps` steps, with the JAX package's
    draws replayed; returns its final state."""
    jtr, ttr, params = _trainers(name)
    tst = ttr.init(params_from_jax(jax.device_get(params)))
    key = jax.random.key(42)
    for t in range(steps):
        tst = ttr.step(tst, {"real": torch.from_numpy(np.array(_batch(t)))},
                       _replay_draws(jtr, params, key, t)).state
    return tst


@pytest.mark.parametrize("name", ["dqgan_bucketed", "adam_bucketed"])
def test_one_launch_exchange_equals_one_launch_a_bucket(name, monkeypatch):
    """The one-worker bucketed step quantizes all of its buckets with ONE
    packed call (`DQGAN._exchange_packed`, one B1 launch on the card).
    Sent back to one call a bucket, two steps give bit-identical state:
    rows are independent, and each bucket's draws land on its own rows."""
    calls = []
    packed = TDQGAN._exchange_packed
    monkeypatch.setattr(TDQGAN, "_exchange_packed",
                        lambda self, *a: calls.append(1) or packed(self, *a))
    one = _run_port(name, 2)
    assert len(calls) == 2
    monkeypatch.setattr(TDQGAN, "_packed_levels", lambda self, *a: None)
    per_bucket = _run_port(name, 2)
    assert len(calls) == 2
    assert one.step == per_bucket.step == 2
    paths, a = T.flatten(one._asdict())
    b = T.flatten_up_to(paths, per_bucket._asdict())
    tensors = [(p, x, y) for p, x, y in zip(paths, a, b)
               if isinstance(x, torch.Tensor)]
    assert any("e1" in T.keystr(p) for p, _, _ in tensors)
    for p, x, y in tensors:
        assert x.dtype == y.dtype and torch.equal(x, y), T.keystr(p)


def test_packed_levels_only_for_one_static_b1_level_count():
    """The one-launch exchange applies where every bucket runs B1 at the
    same static level count, and nowhere else."""
    from repro_torch.core import compressors as TC
    from repro_torch.core.error_feedback import packed_levels
    q8, q4 = TC.get("qsgd8_block1024"), TC.get("qsgd4_block1024")
    assert packed_levels([q8, q8, q8], [2048, 1024, 4096]) == 127
    assert packed_levels([q4], [1024]) == 7
    assert packed_levels([q8, q4], [1024, 1024]) is None
    assert packed_levels([q8, TC.get("qsgd8_linf")], [1024, 1024]) is None
    assert packed_levels([q8, TC.get("identity")], [1024, 1024]) is None
    assert packed_levels([q8], [1536]) is None
    lv = torch.tensor([127.0])
    assert packed_levels([TC.TracedQuant(lv, per_block=1024)], [1024]) is None
