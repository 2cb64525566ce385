"""Port parity: compressed-gradient FSDP (`exchange.parallelism='fsdp'`,
ZeRO stages 2 and 3) in `repro_torch.core.dqgan` against the port's own
replicated step and against `repro.core.dqgan.DQGAN`, the counterparts of
the JAX package's tests/test_fsdp.py.

  * fsdp at full precision (exact reduce-scatter, identity moments) ≡
    replicated DDP (exact), on the bilinear game (adam, oadam, sgd × zero
    2, 3; one worker and four stacked) and on the mixture GAN (oadam,
    zero-3): parameters to rtol 1e-5, atol 1e-6 (tests/test_fsdp.py's);
  * the state slots, and the state's members named as the JAX package's
    (so checkpoints carry the JAX layout);
  * the ledger's two-leg bill equal to `repro.comm.ledger`'s on the same
    layout; the shard-aware layouts equal `repro.comm.buckets`';
  * one worker against the JAX package's one-device compressed fsdp with
    its draws replayed (`split(fold_in(key, step))` into the field's key
    and kq; the reduce-scatter from `fold_in(kq, 100_000 + bid)`, the
    all-gather from `fold_in(·, 1)`), and four stacked workers against
    `DQGAN.step` on 4 forced host devices (a `data` mesh; the chunks of
    the reduce-scatter from `split(·, W)`): exact runs to float32
    rounding (atol 1e-6 of the largest parameter), compressed runs by
    `repro_torch.parity.fsdp_agreement` (the shard owners' authoritative
    state less the workers' mean residual to float32 rounding, the
    parameters within the legs' quantization steps, at most 1e-3 of the
    residuals flipped), loss and grad_norm to rtol 1e-5, and the
    compressed four-worker run's metrics["obs"] (each bucket's
    reduce-scatter operand and residual) by `parity.obs_agreement`;
  * overlap on ≡ off bit for bit under delayed(2);
  * resume 3 + 3 ≡ 6 across packages both ways, and bit-exact within the
    port; a worker-count mismatch refused with the JAX package's text.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import checkpoint as JCK
from repro.comm import buckets as JB
from repro.comm.ledger import CommLedger as JLedger
from repro.comm.planner import plan_comm as jplan_comm
from repro.configs.base import DQConfig as JDQ
from repro.core import compressors as JC
from repro.core import error_feedback as JEF
from repro.core.dqgan import DQGAN as JDQGAN
from repro.models import gan as JG
from repro.strategy import Compression as JComp
from repro.strategy import ExchangePlan as JEx
from repro.strategy import MomentCompression as JMom
from repro.strategy import Strategy as JStrategy
from repro_torch import checkpoint as TCK
from repro_torch import tree as T
from repro_torch.comm import buckets as TB
from repro_torch.comm.ledger import CommLedger as TLedger
from repro_torch.comm.planner import plan_comm as tplan_comm
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.convert import params_from_jax
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import gan as TG
from repro_torch.parity import named_agreement, obs_agreement
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import fsdp_strategy, mixture_params
from torch_ranks import one_thread  # noqa: F401 (autouse)

A = np.random.RandomState(0).randn(8, 8).astype(np.float32)


def _bilinear(params, batch, z=None, generator=None):
    x, y = params["x"], params["y"]
    s = 1.0 + batch["b"].mean()
    At = torch.from_numpy(A)
    return {"x": s * (At @ y), "y": -s * (At.T @ x)}, {"loss": x @ At @ y}


def _strategy(fsdp, zero_stage=3, W=1, kind="exact"):
    axes = ("data",) if W > 1 else ()
    comp = dict(compressor="identity", error_feedback=False, plan="uniform")
    if not fsdp:
        return TStrategy.from_json(JStrategy(
            compression=JComp(**comp),
            exchange=JEx(kind=kind, worker_axes=axes)).to_json())
    return TStrategy.from_json(JStrategy(
        compression=JComp(**comp),
        exchange=JEx(kind=kind, parallelism="fsdp", zero_stage=zero_stage,
                     worker_axes=axes),
        moments=JMom(compressor="identity",
                     error_feedback=False)).to_json())


def _train(strat, field, params, batch, opt, W=1, steps=5, lr=0.05):
    tr = TDQGAN(field_fn=field, dq=TDQ.from_strategy(strat, optimizer=opt,
                                                     lr=lr),
                device="cpu", workers=W)
    st = tr.init(params)
    for _ in range(steps):
        st = tr.step(st, batch).state
    return tr, st


# --------------------------------------------------------------------------- #
# fsdp at full precision ≡ replicated DDP
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("zero_stage", [2, 3])
@pytest.mark.parametrize("opt", ["adam", "oadam", "sgd"])
def test_fsdp_matches_replicated(W, zero_stage, opt):
    params = {"x": torch.ones(8), "y": torch.ones(8)}
    batch = {"b": torch.arange(8, dtype=torch.float32).reshape(8, 1) / 8.0}
    _, a = _train(_strategy(False, W=W), _bilinear, params, batch, opt, W)
    _, b = _train(_strategy(True, zero_stage, W), _bilinear, params, batch,
                  opt, W)
    for k in "xy":
        np.testing.assert_allclose(b.params[k].numpy(), a.params[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W", [1, 4])
def test_fsdp_matches_replicated_gan(W):
    cfg = TG.GANConfig(image_size=0, data_dim=2, hidden=16, latent_dim=8)
    params = TG.init(cfg, generator=torch.Generator().manual_seed(0))
    batch = {"real": torch.from_numpy(
        np.random.RandomState(0).randn(16, 2).astype(np.float32))}
    field = TG.gan_field_fn(cfg)
    _, a = _train(_strategy(False, W=W), field, params, batch, "oadam", W, 4,
                  lr=0.02)
    _, b = _train(_strategy(True, 3, W), field, params, batch, "oadam", W, 4,
                  lr=0.02)
    for la, lb in zip(T.flatten(a.params)[1], T.flatten(b.params)[1]):
        np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _names(tree):
    return {n: tuple(np.shape(x)) for n, x in TCK._paths(tree)}


def test_fsdp_state_slots():
    params = {"x": torch.ones(8), "y": torch.ones(8)}
    tr = TDQGAN(field_fn=_bilinear, device="cpu",
                dq=TDQ.from_strategy(_strategy(True, 3), optimizer="adam",
                                     lr=0.05))
    st = tr.init(params)
    assert st.m is None and st.v is None and st.prev_update is None
    assert set(st.fsdp) == {"0"}                  # one flat bucket
    slot = st.fsdp["0"]
    assert set(slot) == {"m", "v", "w", "age"}    # zero3 carries params
    # w is seeded from the packed initial parameters, then padding
    np.testing.assert_array_equal(slot["w"][0, :16].numpy(), np.ones(16))
    assert not slot["w"][0, 16:].any() and slot["w"].shape == (1, 1024)
    st2 = TDQGAN(field_fn=_bilinear, device="cpu",
                 dq=TDQ.from_strategy(_strategy(True, 2), optimizer="oadam",
                                      lr=0.05)).init(params)
    assert set(st2.fsdp["0"]) == {"m", "v", "dir", "age"}
    # the JAX package's state, member for member
    for zero_stage, opt in ((3, "adam"), (2, "oadam"), (3, "sgd")):
        strat = _strategy(True, zero_stage)
        jtr = JDQGAN(field_fn=None, dq=JDQ.from_strategy(
            JStrategy.from_json(strat.to_json()), optimizer=opt, lr=0.05))
        jst = jtr.init({"x": jnp.ones(8), "y": jnp.ones(8)})
        tst = TDQGAN(field_fn=_bilinear, device="cpu",
                     dq=TDQ.from_strategy(strat, optimizer=opt,
                                          lr=0.05)).init(params)
        assert _names(tst) == _names(jax.device_get(jst))


@pytest.mark.parametrize("make,match", [
    (dict(lr_mults=(("x", 2.0),)), "lr_mults groups params"),
    (dict(extrapolation="global", optimizer="omd"),
     "extrapolation='global' needs"),
])
def test_fsdp_refusals_at_init(make, match):
    kw = dict(optimizer="adam", lr=0.05)
    kw.update(make)
    tr = TDQGAN(field_fn=_bilinear, device="cpu",
                dq=TDQ.from_strategy(_strategy(True, 3), **kw))
    with pytest.raises(ValueError, match=match):
        tr.init({"x": torch.ones(8), "y": torch.ones(8)})


def test_fsdp_refuses_a_skipped_leaf():
    """A leaf the layout skips (sharded outside the worker axes) cannot
    enter a flat bucket: init names it, with the JAX package's text."""
    tr = TDQGAN(field_fn=_bilinear, device="cpu",
                dq=TDQ.from_strategy(_strategy(True, 3), optimizer="adam",
                                     lr=0.05))
    layout = TB.build_layout({"x": (8,), "y": (8,)},
                             {"x": ("model",), "y": ()}, 1)
    cplan = tplan_comm(layout, "identity", "uniform")
    params = {"x": torch.ones(8), "y": torch.ones(8)}
    tr._comm_cache[tuple(zip(*T.flatten(T.tree_map(
        lambda x: tuple(x.shape), params))))] = (layout, cplan, None, None)
    with pytest.raises(ValueError, match=r"skipped leaf index\(es\) \[0\]"):
        tr.init(params)


# --------------------------------------------------------------------------- #
# the ledger's two legs and the shard-aware layouts
# --------------------------------------------------------------------------- #
MIX_SHAPES = {"gen": {"l1": {"w": (16, 128), "b": (128,)},
                      "l2": {"w": (128, 2), "b": (2,)}},
              "disc": {"l1": {"w": (2, 128), "b": (128,)},
                       "l2": {"w": (128, 128), "b": (128,)},
                       "l3": {"w": (128, 1), "b": (1,)}}}


@pytest.mark.parametrize("kind,moments", [
    ("two_phase", "qsgd8_block1024"), ("two_phase", "qsgd8_linf"),
    ("exact", "identity"), ("exact", "qsgd4_block1024")])
@pytest.mark.parametrize("W", [1, 4])
def test_ledger_bills_both_legs_as_the_jax_package(kind, moments, W):
    tl = TB.build_layout(MIX_SHAPES, None, W, bucket_bytes=30_000)
    jl = JB.build_layout(MIX_SHAPES, None, W, bucket_bytes=30_000)
    comp = "qsgd8_block1024" if kind == "two_phase" else "identity"
    t = TLedger.from_plan(tl, tplan_comm(tl, comp, "uniform"), kind, W, comp,
                          moment_compressor=moments)
    j = JLedger.from_plan(jl, jplan_comm(jl, comp, "uniform"), kind, W, comp,
                          moment_compressor=moments)
    assert len(t.entries) == len(j.entries) > 1
    for a, b in zip(t.entries, j.entries):
        assert a.wire_bytes == pytest.approx(b.wire_bytes, rel=1e-12)
        assert a.carried_bytes == pytest.approx(b.carried_bytes, rel=1e-12)
    for n in (None, W):
        assert t.round_bytes(n) == pytest.approx(j.round_bytes(n))
    t.tick()
    j.tick()
    assert t.summary() == j.summary()
    # both legs: more than the reduce-scatter alone
    one = TLedger.from_plan(tl, tplan_comm(tl, comp, "uniform"), kind, W,
                            comp)
    if kind == "two_phase":
        assert t.wire_bytes_per_step > 0.5 * one.wire_bytes_per_step


def _slots(layout):
    def slot(s):
        return (s.index, s.path, s.shape, s.size, s.bucket, s.offset, s.local)
    return ([(b.bid, b.size, b.used, [slot(s) for s in b.slots])
             for b in layout.buckets], [slot(s) for s in layout.skipped])


def test_layout_buckets_data_sharded_leaf_at_local_shape():
    shapes = {"w": (16, 4), "b": (4,)}
    lay = TB.build_layout(shapes, {"w": ("data",), "b": ()}, n_workers=4,
                          shard_axes=("data",), axis_sizes={"data": 4})
    assert not lay.skipped
    slots = {s.path: s for b in lay.buckets for s in b.slots}
    w = next(s for p, s in slots.items() if "w" in p)
    assert w.local and w.shape == (4, 4)        # 16/4 rows per owner
    b_ = next(s for p, s in slots.items() if "b" in p)
    assert not b_.local and b_.shape == (4,)
    jlay = JB.build_layout(shapes, {"w": P("data"), "b": P()}, n_workers=4,
                           shard_axes=("data",), axis_sizes={"data": 4})
    assert _slots(lay) == _slots(jlay)


def test_layout_skips_leaf_sharded_outside_shard_axes():
    kw = dict(n_workers=4, shard_axes=("data",),
              axis_sizes={"data": 4, "model": 2})
    lay = TB.build_layout({"w": (16, 4)}, {"w": ("model",)}, **kw)
    assert len(lay.skipped) == 1 and not lay.buckets
    # an uneven shard skips too
    lay2 = TB.build_layout({"w": (6, 4)}, {"w": ("data",)}, **kw)
    assert len(lay2.skipped) == 1
    assert _slots(lay2) == _slots(JB.build_layout(
        {"w": (6, 4)}, {"w": P("data")}, **kw))


def test_layout_treats_size1_axis_sharding_as_replication():
    shapes = {"w": (16, 4)}
    lay = TB.build_layout(shapes, {"w": ("model",)}, n_workers=4,
                          axis_sizes={"data": 4, "model": 1})
    assert not lay.skipped and lay.buckets
    # without axis_sizes the spec is (conservatively) a real shard
    lay2 = TB.build_layout(shapes, {"w": ("model",)}, n_workers=4)
    assert len(lay2.skipped) == 1
    assert _slots(lay) == _slots(JB.build_layout(
        shapes, {"w": P("model")}, n_workers=4,
        axis_sizes={"data": 4, "model": 1}))


def test_compression_build_passes_the_shard_axes():
    strat = fsdp_strategy(3)
    layout, plan = strat.compression.build(
        {"w": (16, 4), "b": (4,)}, {"w": ("data",), "b": ()}, 4,
        shard_axes=("data",), axis_sizes={"data": 4})
    assert not layout.skipped and len(plan.assignments) == 1


# --------------------------------------------------------------------------- #
# against the JAX package: one worker, draws replayed
# --------------------------------------------------------------------------- #
B1W, STEPS1 = 16, 6
JCFG = JG.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                    hidden=32)
TCFG = TG.GANConfig(**{f: getattr(JCFG, f) for f in JCFG.__dataclass_fields__})
KEY = 42


def _jax_fsdp_strategy(kind, zero_stage, moments, W=1, overlap=False,
                       schedule=None, metrics="off"):
    from repro.strategy import Observability as JObs
    from repro.strategy import Schedule as JSched
    exact = kind == "exact"
    return JStrategy(
        compression=JComp(compressor="identity" if exact
                          else "qsgd8_block1024", error_feedback=not exact,
                          plan="uniform", bucket_mb=0.03),
        exchange=JEx(kind=kind, parallelism="fsdp", zero_stage=zero_stage,
                     worker_axes=("data",) if W > 1 else (),
                     overlap=overlap),
        schedule=schedule or JSched(),
        moments=JMom(compressor=moments,
                     error_feedback=moments != "identity"),
        observability=JObs(metrics=metrics))


def _draw(comp, key, d, use_ef):
    """What `compress_with_ef` draws from `key` for a (d,) operand."""
    if use_ef and JEF.fused_compatible(comp, jax.ShapeDtypeStruct(
            (d,), jnp.float32)):
        return np.asarray(jax.random.uniform(key, (d,)))
    if isinstance(comp, JC.StochasticQuant):
        b = comp.per_block
        return np.asarray(jax.random.uniform(
            key, (1, d) if b <= 0 else (-(-d // b), b)))
    return None


def _one_worker_draws(jtr, params, step):
    """The port's `draws` for one step of the JAX one-device fsdp step."""
    kfield, kq = jax.random.split(jax.random.fold_in(jax.random.key(KEY),
                                                     step))
    draws = {"z": torch.from_numpy(np.array(
        jax.random.normal(kfield, (B1W, JCFG.latent_dim)))), "rand": {}}
    layout, cplan = jtr._comm(params)
    mom = jtr.strategy.moments
    for b, a in zip(layout.buckets, cplan.assignments):
        k = jax.random.fold_in(kq, 100_000 + b.bid)
        r = {}
        if jtr.strategy.exchange.kind != "exact":
            r["reduce_scatter"] = _draw(JC.get(a.compressor), k, b.size,
                                        jtr.dq.error_feedback)
        r["all_gather"] = _draw(mom.get(), jax.random.fold_in(k, 1), b.size,
                                mom.error_feedback)
        draws["rand"][b.bid] = {n: torch.from_numpy(np.array(x))[None]
                                for n, x in r.items() if x is not None}
    return draws


def _real(t):
    return np.random.RandomState(100 + t).randn(B1W, 2).astype(np.float32)


ONE_WORKER = {
    "two_phase_zero3_omd": ("two_phase", 3, "qsgd8_block1024", "omd"),
    "two_phase_zero2_omd": ("two_phase", 2, "qsgd8_block1024", "omd"),
    "two_phase_zero3_linf_moments": ("two_phase", 3, "qsgd8_linf", "omd"),
    "exact_zero3_adam": ("exact", 3, "identity", "adam"),
}


def _one_worker_trainers(name):
    kind, zs, moments, opt = ONE_WORKER[name]
    jstrat = _jax_fsdp_strategy(kind, zs, moments)
    kw = dict(optimizer=opt, lr=1e-2,
              message="update" if opt == "omd" else "grad")
    jtr = JDQGAN(field_fn=JG.gan_field_fn(JCFG),
                 dq=JDQ.from_strategy(jstrat, **kw))
    ttr = TDQGAN(field_fn=TG.gan_field_fn(TCFG), device="cpu",
                 dq=TDQ.from_strategy(TStrategy.from_json(jstrat.to_json()),
                                      **kw))
    return jstrat, jtr, ttr


def _jnamed(state):
    return {n: np.asarray(x) for n, x in TCK._paths(jax.device_get(state))}


def _tnamed(state):
    return {n: (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for n, x in TCK._paths(state)}


def _assert_fsdp_agree(ref, got, W, layout, exact=False, adam_move=0.0):
    """Exact runs: parameters and shard slots to float32 rounding (1e-6 of
    the largest parameter). Under Adam (`adam_move` = 2·lr·steps), whose
    direction m̂/√v̂ scales a gradient that cancels to near zero up to
    O(1), a rounding difference there moves its element by up to 2·lr a
    step: at most 1e-3 of the elements may lie beyond rounding, all
    within `adam_move` (tests/test_torch_dqgan.py's CPOAdam-GQ rule).
    Compressed runs: `fsdp_agreement`."""
    if exact:
        scale = max(np.abs(v).max() for k, v in ref.items()
                    if k.startswith("params/"))
        keys = [k for k in ref if k.startswith(("params/", "fsdp/"))]
        off = sum(int((np.abs(got[k] - ref[k]) > 1e-6 * scale).sum())
                  for k in keys) / sum(ref[k].size for k in keys)
        assert off <= (1e-3 if adam_move else 0.0), off
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=max(1e-6 * scale, adam_move),
                                       err_msg=k)
        return
    problems = named_agreement(ref, got, W, W, layout).problems
    assert not problems, problems


@pytest.fixture(scope="module")
def one_worker_runs():
    """{name: (JAX trainer, port trainer, strategy, JAX states by step,
    port states by step, metrics of both)} over STEPS1 steps."""
    out = {}
    params = JG.init(jax.random.key(0), JCFG)
    for name in ONE_WORKER:
        jstrat, jtr, ttr = _one_worker_trainers(name)
        jst = jtr.init(params)
        tst = ttr.init(params_from_jax(jax.device_get(params)))
        step = jax.jit(jtr.step)
        jstates, tstates, metrics = [jst], [tst], []
        for t in range(STEPS1):
            real = _real(t)
            jout = step(jst, {"real": jnp.asarray(real)},
                        jax.random.key(KEY))
            tout = ttr.step(tst, {"real": torch.from_numpy(real)},
                            _one_worker_draws(jtr, params, t))
            jst, tst = jout.state, tout.state
            jstates.append(jst)
            tstates.append(tst)
            metrics.append((jax.device_get(jout.metrics), tout.metrics))
        out[name] = (jtr, ttr, jstrat, step, jstates, tstates, metrics)
    return out


@pytest.mark.parametrize("name", list(ONE_WORKER))
def test_one_worker_matches_jax(one_worker_runs, name):
    jtr, ttr, _, _, jstates, tstates, metrics = one_worker_runs[name]
    layout = ttr._comm(tstates[0].params)[0]
    _assert_fsdp_agree(_jnamed(jstates[-1]), _tnamed(tstates[-1]), 1, layout,
                       exact=name.startswith("exact"),
                       adam_move=(2 * 1e-2 * STEPS1
                                  if ONE_WORKER[name][3] == "adam" else 0.0))
    for jm, tm in metrics:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("fmt", ["npz", "shards2"])
def test_resume_across_packages(one_worker_runs, tmp_path, direction, fmt):
    """3 steps, a checkpoint by one package, 3 more by the other ≡ 6
    steps of the first (the draws replayed)."""
    jtr, ttr, strat, step, jstates, tstates, _ = one_worker_runs[
        "two_phase_zero3_omd"]
    meta = {"strategy": strat.to_json()}
    path = str(tmp_path / ("mid.npz" if fmt == "npz" else "mid"))
    params = JG.init(jax.random.key(0), JCFG)
    src = (JCK if direction == "jax_to_port" else TCK)
    mid = (jax.device_get(jstates[3]) if direction == "jax_to_port"
           else tstates[3])
    if fmt == "npz":
        src.save(path, mid, step=3, meta=meta)
    else:
        src.save_sharded(path, mid, step=3, meta=meta, n_shards=2)
    if direction == "jax_to_port":
        TCK.verify_strategy(path, ttr.strategy)
        st = (TCK.restore if fmt == "npz" else TCK.restore_sharded)(
            path, tstates[0])
        for t in range(3, 6):
            st = ttr.step(st, {"real": torch.from_numpy(_real(t))},
                          _one_worker_draws(jtr, params, t)).state
        ref, got = _jnamed(jstates[6]), _tnamed(st)
    else:
        st = (JCK.restore if fmt == "npz" else JCK.restore_sharded)(
            path, jstates[0])
        for t in range(3, 6):
            st = step(st, {"real": jnp.asarray(_real(t))},
                      jax.random.key(KEY)).state
        ref, got = _tnamed(tstates[6]), _jnamed(st)
    assert list(ref) == list(got)
    _assert_fsdp_agree(ref, got, 1, ttr._comm(tstates[0].params)[0])


def test_port_resume_is_bit_exact(tmp_path):
    """Four stacked workers, compressed zero-2 under oadam: 3 steps, a
    sharded checkpoint, a fresh trainer restored from it and 3 more ≡ 6
    uninterrupted steps, bit for bit (the generators re-seed from (seed,
    step, worker)); a trainer of 2 workers refuses the checkpoint."""
    from torch_ranks import _torch, make_trainer, strategy_case
    case = strategy_case(fsdp_strategy(2), steps=6, optimizer="oadam")
    _, _, params = mixture_params()

    def run(tr, st, lo, hi):
        for t in range(lo, hi):
            st = tr.step(st, {"real": _torch(case["batches"][t])}).state
        return st

    tr = make_trainer(case)
    full = run(tr, tr.init(params), 0, 6)
    mid = run(tr, tr.init(params), 0, 3)
    path = str(tmp_path / "ck")
    TCK.save_sharded(path, mid, step=3, n_shards=2)
    tr2 = make_trainer(case)
    resumed = run(tr2, TCK.restore_sharded(path, tr2.init(params)), 3, 6)
    a, b = _tnamed(full), _tnamed(resumed)
    assert list(a) == list(b) and any(k.startswith("fsdp/") for k in a)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    two = make_trainer(dict(case, W=2))
    with pytest.raises(ValueError, match="fsdp shard slots"):
        TCK.restore_sharded(path, two.init(params))


# --------------------------------------------------------------------------- #
# overlap on ≡ off
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("W", [1, 4])
def test_overlap_on_equals_off(W):
    from torch_ranks import _torch, make_trainer, strategy_case
    _, _, params = mixture_params()
    res = {}
    for ov in (False, True):
        strat = fsdp_strategy(3, overlap=ov, schedule=("delayed", 2))
        if W == 1:
            strat = strat.evolve(worker_axes=())
        case = dict(strategy_case(strat, steps=6), W=W)
        tr = make_trainer(case)
        st = tr.init(params)
        for real in case["batches"]:
            st = tr.step(st, {"real": _torch(real)}).state
        res[ov] = _tnamed(st)
    assert list(res[False]) == list(res[True])
    for k in res[False]:
        np.testing.assert_array_equal(res[True][k], res[False][k], err_msg=k)


# --------------------------------------------------------------------------- #
# four workers against the JAX package on 4 forced host devices
# --------------------------------------------------------------------------- #
W4, B4, STEPS4 = 4, 64, 3
# name: (kind, zero stage, moment compressor, optimizer); the compressed
# run records the step's telemetry (metrics full) on both sides
FOUR_WORKERS = {
    "exact_zero2_adam": ("exact", 2, "identity", "adam"),
    "exact_zero3_omd": ("exact", 3, "identity", "omd"),
    "two_phase_zero3_omd": ("two_phase", 3, "qsgd8_block1024", "omd"),
}
OBS_FULL = ("two_phase_zero3_omd",)

SCRIPT = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.parallel.compat import make_mesh, set_mesh
from repro.configs.base import DQConfig
from repro.core import compressors as C
from repro.core import error_feedback as EF
from repro.core.dqgan import DQGAN
from repro.models.gan import GANConfig, mlp_gan_init, gan_field_fn
from repro.strategy import Strategy

W, B, STEPS = %(W)d, %(B)d, %(steps)d
CONFIGS = json.loads(%(configs)r)
mesh = make_mesh((W,), ("data",))
cfg = GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                hidden=128)
params = mlp_gan_init(jax.random.key(0), cfg)
KEY = jax.random.key(7)
out = {}


def put(name, x):
    out[name] = np.asarray(jax.device_get(x))


def draw(comp, key, d, use_ef):
    if use_ef and EF.fused_compatible(comp, jax.ShapeDtypeStruct(
            (d,), jnp.float32)):
        return jax.random.uniform(key, (d,))
    b = comp.per_block
    return jax.random.uniform(key, (1, d) if b <= 0 else (-(-d // b), b))


def record_draws(tr, name, step):
    pre = f"{name}/draws/{step}"
    kqs, zs = [], []
    for w in range(W):
        kf, kq = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(KEY, w), step))
        zs.append(jax.random.normal(kf, (B // W, cfg.latent_dim)))
        kqs.append(kq)
    put(f"{pre}/z", jnp.stack(zs))
    layout, cplan = tr._comm(params)
    mom = tr.strategy.moments
    for b, a in zip(layout.buckets, cplan.assignments):
        comp, c = C.get(a.compressor), b.size // W
        keys = [jax.random.fold_in(k, 100_000 + b.bid) for k in kqs]
        if tr.strategy.exchange.kind == "two_phase":
            put(f"{pre}/rand/{b.bid}/reduce_scatter", jnp.stack([
                jnp.stack([draw(comp, kk, c, False)
                           for kk in jax.random.split(k, W)])
                for k in keys]))
        if mom.compressor != "identity":
            put(f"{pre}/rand/{b.bid}/all_gather", jnp.stack([
                draw(mom.get(), jax.random.fold_in(k, 1), c,
                     mom.error_feedback) for k in keys]))


for name, (sjson, opt) in CONFIGS.items():
    strat = Strategy.from_json(sjson)
    tr = DQGAN(field_fn=gan_field_fn(cfg),
               dq=DQConfig.from_strategy(
                   strat, optimizer=opt, lr=1e-2,
                   message="update" if opt == "omd" else "grad"),
               mesh=mesh, batch_spec=P(("data",)))
    with set_mesh(mesh):
        step = jax.jit(tr.step)
        st = tr.init(params)
        for t in range(STEPS):
            real = jax.random.normal(jax.random.fold_in(
                jax.random.key(1), t), (B, 2))
            put(f"{name}/batch/{t}", real)
            record_draws(tr, name, t)
            res = step(st, {"real": real}, KEY)
            st = res.state
            for k in ("loss", "grad_norm"):
                put(f"{name}/metrics/{t}/{k}", res.metrics[k])
            for k, v in res.metrics.get("obs", {}).items():
                put(f"{name}/metrics/{t}/obs/{k}", v)
    st = jax.device_get(st)
    from jax.tree_util import tree_flatten_with_path, keystr
    for path, x in tree_flatten_with_path(st)[0]:
        put(f"{name}/state" + keystr(path), x)
for i, x in enumerate(jax.tree.leaves(params)):
    put(f"init/{i}", x)
np.savez(%(path)r, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_four_workers(tmp_path_factory):
    from conftest import run_multidevice
    path = str(tmp_path_factory.mktemp("fsdp4") / "runs.npz")
    configs = {n: (_jax_fsdp_strategy(
        k, zs, mom, W=W4,
        metrics="full" if n in OBS_FULL else "off").to_json(), opt)
        for n, (k, zs, mom, opt) in FOUR_WORKERS.items()}
    out = run_multidevice(SCRIPT % dict(W=W4, B=B4, steps=STEPS4, path=path,
                                        configs=json.dumps(configs)),
                          n_devices=W4)
    assert "OK" in out
    data = dict(np.load(path))
    os.remove(path)
    return configs, data


def _jax_state(data, name, like):
    """The JAX run's final state under the port's member names: JAX's
    key paths (".step", "['gen']['l1']['w']") put in the checkpoint
    layout's `/`-joined form."""
    import re
    pre = f"{name}/state"
    out = {}
    for k, v in data.items():
        if not k.startswith(pre):
            continue
        parts = re.findall(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]", k[len(pre):])
        out["/".join(a or b or c for a, b, c in parts)] = v
    return {n: out[n] for n in like}


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(FOUR_WORKERS))
def test_four_workers_match_jax(jax_four_workers, name):
    configs, data = jax_four_workers
    sjson, opt = configs[name]
    tr = TDQGAN(field_fn=TG.gan_field_fn(TG.GANConfig(
        name="mix", image_size=0, data_dim=2, latent_dim=16, hidden=128)),
        dq=TDQ.from_strategy(TStrategy.from_json(sjson), optimizer=opt,
                             lr=1e-2,
                             message="update" if opt == "omd" else "grad"),
        device="cpu", workers=W4)
    paths, _ = T.flatten(TG.init(TG.GANConfig(
        name="mix", image_size=0, data_dim=2, latent_dim=16, hidden=128),
        device="meta"))
    st = tr.init(T.unflatten(paths, [torch.from_numpy(data[f"init/{i}"])
                                     for i in range(len(paths))]))
    for t in range(STEPS4):
        pre = f"{name}/draws/{t}/"
        draws = {"z": torch.from_numpy(data[pre + "z"]), "rand": {}}
        for k, v in data.items():
            if k.startswith(pre + "rand/"):
                bid, leg = k[len(pre + "rand/"):].split("/")
                draws["rand"].setdefault(int(bid), {})[leg] = \
                    torch.from_numpy(v)
        out = tr.step(st, {"real": torch.from_numpy(
            data[f"{name}/batch/{t}"])}, draws)
        st = out.state
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                float(out.metrics[k]), float(data[f"{name}/metrics/{t}/{k}"]),
                rtol=1e-5, atol=1e-7)
        pre = f"{name}/metrics/{t}/obs/"
        jo = {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
        assert bool(jo) == (name in OBS_FULL) == ("obs" in out.metrics)
        if jo:
            # each bucket's reduce-scatter operand and residual
            to = out.metrics["obs"]
            assert sorted(jo) == sorted(to) and "bucket_delta" in to
            problems = obs_agreement({k: jo[k] for k in to}, to)
            assert not problems, (t, problems)
    got = _tnamed(st)
    ref = _jax_state(data, name, got)
    assert sorted(ref) == sorted(got)
    _assert_fsdp_agree(ref, got, W4, tr._comm(st.params)[0],
                       exact=name.startswith("exact"),
                       adam_move=2 * 1e-2 * STEPS4 if opt == "adam" else 0.0)
