"""Port parity: `repro_torch.sched` and the schedule dataflow of the
port's DQGAN step against `repro.sched` and `repro.core.dqgan`.

  * every numpy function of `sched.{schedule,straggler,server,clock}` on
    the same inputs gives the same output (exactly: the port's modules
    are copies), over the straggler profiles where a function takes one;
  * one worker on the mixture MLP GAN, 8 steps under `local_k(4)` and
    `delayed(τ)` for τ in {1, 2, 3}, per leaf (`qsgd8_linf`) and over
    comm buckets (`qsgd8_block1024`, the packed one-launch exchange), with
    the JAX step's draws replayed, to `tests/test_torch_dqgan.py`'s
    tolerance: params − e1 to float32 rounding (1e-6 of the largest
    parameter plus 1e-6·127·max|e1|), params within one quantization step
    more, at most 1e-3 of the residuals off by a flipped code; the
    schedule's slots (the accumulated message, the pending ring) to
    float32 rounding of the message scale grown over the steps (a flipped
    code moves the next field by little) and the version vector exactly;
  * `local_k(1)` is `every_step`, bit for bit.
The four-worker τ-vector runs are in `tests/test_torch_multiworker.py`.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as JS
from repro.configs.base import DQConfig as JDQ
from repro.core import compressors as JC
from repro.core import error_feedback as JEF
from repro.core.dqgan import DQGAN as JDQGAN
from repro.models import gan as JG
from repro.strategy import Compression as JComp
from repro.strategy import Schedule as JSched
from repro.strategy import Strategy as JStrategy
from repro_torch import sched as TS
from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.convert import params_from_jax
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import gan as TG
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import one_thread  # noqa: F401 (autouse)

PROFILES = ("none", "mild", "heavy")


# --------------------------------------------------------------------------- #
# the numpy modules
# --------------------------------------------------------------------------- #
def _schedules(S):
    return [S.get("every_step"), S.get("local_k", 3), S.get("delayed"),
            S.get("delayed", tau=4)]


def _case_schedule(S, _):
    return [([(s.is_exchange_step(i), s.round_index(i)) for i in range(10)],
             s.exchanges_in(10), s.describe(), s.staleness, s.period)
            for s in _schedules(S)]


def _case_seeded_tau_vector(S, _):
    return [S.seeded_tau_vector(t, m, seed) for t in (1, 2, 4)
            for m in (1, 4, 8) for seed in (0, 5)]


def _case_worker_slowdowns(S, p):
    return S.worker_slowdowns(S.get_profile(p), 8, seed=3)


def _case_step_times(S, p):
    return S.step_times(S.get_profile(p), 4, 25, seed=2, base=0.01)


def _case_simulate(S, p):
    times = S.step_times(S.get_profile(p), 4, 24, seed=1, base=0.01)
    out = []
    for s in _schedules(S):
        for frac in (1.0, 0.5):
            for dataflow in (("auto", "sync", "server")
                             if s.name == "delayed" else ("auto",)):
                out.append(S.simulate(s, times, 0.004, frac, 7, dataflow))
    return out


def _case_simulate_push_pull(S, p):
    times = S.step_times(S.get_profile(p), 4, 30, seed=4, base=0.01)
    return [S.simulate_push_pull(times, 0.003, tau, frac, 2)
            for tau in (1, 2, 4) for frac in (1.0, 0.5)]


def _case_time_per_step(S, p):
    return [S.time_per_step(s, S.get_profile(p), 4, 20, 0.04, 2e6,
                            S.LinkModel(), 0.75, 3) for s in _schedules(S)]


def _case_speedup_vs_M(S, p):
    return [S.speedup_vs_M(s, S.get_profile(p), (1, 2, 4, 8), 16, 0.05,
                           lambda m: 1e6 * m) for s in _schedules(S)]


def _case_baseline_mean_step(S, p):
    return S.baseline_mean_step(S.get_profile(p), 20, 0.05)


def _case_versioned_server(S, _):
    srv = S.VersionedServer(n_workers=3, tau=1)
    log = []
    for w in (0, 1, 2, 0, 1, 2):
        log.append(("pull", w, srv.pull(w)))
    for w in (0, 1, 2, 0, 1):
        log.append(("push", w, srv.push(w), srv.version,
                    [srv.staleness(i) for i in range(3)],
                    [srv.can_push(i) for i in range(3)]))
    try:
        srv.push(2)
        srv.push(2)
    except S.StalenessBoundExceeded as e:
        log.append(("refused", str(e)))
    return log


def _case_link_model(S, tmp):
    link = S.LinkModel(bandwidth_Bps=2e9, latency_s=5e-5)
    path = tmp / "calib.json"
    path.write_text(json.dumps({"bandwidth_Bps": 3e9, "latency_s": 2e-4,
                                "t_compute_s": 0.01}))
    loaded, payload = S.clock.load_calibration(str(path))
    return ([link.exchange_time(b) for b in (0, 1, 1e6, 3.5e7)],
            loaded, payload, S.LinkModel.from_dict(payload))


def _case_profiles(S, p):
    prof = S.get_profile(p)
    return prof, prof.describe(), sorted(S.PROFILES)


CASES = [(f, p) for f in ("worker_slowdowns", "step_times", "simulate",
                          "simulate_push_pull", "time_per_step",
                          "speedup_vs_M", "baseline_mean_step", "profiles")
         for p in PROFILES]
CASES += [(f, None) for f in ("schedule", "seeded_tau_vector",
                              "versioned_server", "link_model")]


def _same(a, b):
    """Structural equality; numpy arrays equal elementwise; dataclasses of
    the two packages by their fields."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        _same(vars(a), vars(b))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("func,profile", CASES)
def test_numpy_functions_match(func, profile, tmp_path):
    fn = globals()[f"_case_{func}"]
    arg = tmp_path if func == "link_model" else profile
    _same(fn(JS, arg), fn(TS, arg))


def test_invalid_schedules_refused_by_both():
    for args in [("nope",), ("local_k", 0), ("every_step", 2)]:
        with pytest.raises(ValueError):
            JS.ExchangeSchedule(*args)
        with pytest.raises(ValueError):
            TS.ExchangeSchedule(*args)
    with pytest.raises(ValueError):
        TS.get_profile("nope")


# --------------------------------------------------------------------------- #
# the schedule dataflow of the step, one worker
# --------------------------------------------------------------------------- #
B, STEPS, LR = 16, 8, 1e-2
JCFG = JG.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                    hidden=32)
TCFG = TG.GANConfig(**{f: getattr(JCFG, f)
                       for f in JCFG.__dataclass_fields__})
COMPRESSION = {"per_leaf": dict(compressor="qsgd8_linf"),
               "bucketed": dict(compressor="qsgd8_block1024", plan="uniform",
                                bucket_mb=0.003)}
SCHEDULES = {"local_k4": JSched.local_k(4), "delayed1": JSched.delayed(1),
             "delayed2": JSched.delayed(2), "delayed3": JSched.delayed(3)}


def replay_draws(jtr, params, key, step, batch):
    """The port's `draws` for one step: what the JAX step draws from key
    (`split(fold_in(key, step))` into the field's key and the quantizer's,
    `fold_in(kq, leaf index)` per leaf, `fold_in(kq, 100_000 + bucket
    id)` per bucket)."""
    kfield, kq = jax.random.split(jax.random.fold_in(key, step))
    draws = {"z": torch.from_numpy(np.array(
        jax.random.normal(kfield, (batch, JCFG.latent_dim)))), "rand": {}}
    if jtr.bucketed:
        layout, cplan = jtr._comm(params)
        streams = [(b.bid, JC.get(a.compressor), (b.size,), 100_000 + b.bid)
                   for b, a in zip(layout.buckets, cplan.assignments)]
    else:
        streams = [(i, jtr.compressor, tuple(x.shape), i)
                   for i, x in enumerate(jax.tree.leaves(params))]
    for sid, comp, shape, fold in streams:
        k = jax.random.fold_in(kq, fold)
        d = math.prod(shape)
        if jtr.dq.error_feedback and JEF.fused_compatible(
                comp, jax.ShapeDtypeStruct(shape, jnp.float32)):
            r = jax.random.uniform(k, (d,))
        else:
            b = comp.per_block
            r = jax.random.uniform(k, (1, d) if b <= 0 else
                                   (-(-d // b), b))
        draws["rand"][sid] = torch.from_numpy(np.array(r))
    return draws


def trainers(jstrat, workers=1, optimizer="omd"):
    kw = dict(optimizer=optimizer, lr=LR,
              message="update" if optimizer == "omd" else "grad")
    jtr = JDQGAN(field_fn=JG.gan_field_fn(JCFG),
                 dq=JDQ.from_strategy(jstrat, **kw))
    ttr = TDQGAN(field_fn=TG.gan_field_fn(TCFG),
                 dq=TDQ.from_strategy(TStrategy.from_json(jstrat.to_json()),
                                      **kw), device="cpu", workers=workers)
    return jtr, ttr


def run_both(jstrat, steps=STEPS):
    """(JAX trainer, JAX final state, port final state)."""
    jtr, ttr = trainers(jstrat)
    params = JG.init(jax.random.key(0), JCFG)
    jst = jtr.init(params)
    tst = ttr.init(params_from_jax(jax.device_get(params)))
    step = jax.jit(jtr.step, static_argnums=(3,))
    key = jax.random.key(42)
    sched = jtr.strategy.schedule.runtime()
    rs = np.random.RandomState(3)
    for t in range(steps):
        real = rs.randn(B, 2).astype(np.float32)
        ex = sched.is_exchange_step(t)
        draws = replay_draws(jtr, params, key, t, B)
        jst = step(jst, {"real": jnp.asarray(real)}, key, ex).state
        tst = ttr.step(tst, {"real": torch.from_numpy(real)}, draws,
                       do_exchange=ex).state
    return jtr, jax.device_get(jst), tst


def assert_ef_invariant(jtr, jst, tst, paths):
    """test_torch_dqgan's EF tolerance; returns max|e1|."""
    jp = [np.asarray(x) for x in T.flatten_up_to(paths, jst.params)]
    tp = [x.numpy() for x in T.flatten_up_to(paths, tst.params)]
    jl = jst.ef["leaf"] if jtr.bucketed else jst.ef
    tl = tst.ef["leaf"] if jtr.bucketed else tst.ef
    je = [np.asarray(x["e1"]).sum(0) for x in T.flatten_up_to(paths, jl)]
    te = [x["e1"].numpy().sum(0) for x in T.flatten_up_to(paths, tl)]
    emax = max(np.abs(x).max() for x in je)
    flips = sum(int((np.abs(a - b) > 1e-3 * emax).sum())
                for a, b in zip(je, te)) / sum(x.size for x in je)
    assert flips <= 1e-3, flips
    scale = max(np.abs(x).max() for x in jp)
    atol = 1e-6 * scale + 1e-6 * 127 * emax
    for a, b, x, y in zip(jp, tp, je, te):
        np.testing.assert_allclose(b - y, a - x, rtol=0, atol=atol)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol + emax)
    return emax


@pytest.mark.parametrize("comp", sorted(COMPRESSION))
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_one_worker_schedule_matches(sched, comp):
    jstrat = JStrategy(compression=JComp(**COMPRESSION[comp]),
                       schedule=SCHEDULES[sched])
    jtr, jst, tst = run_both(jstrat)
    paths, _ = T.flatten(tst.params)
    assert tst.step == int(jst.step) == STEPS
    emax = assert_ef_invariant(jtr, jst, tst, paths)
    assert sorted(tst.sched) == sorted(jst.sched)
    slot = "accum" if "accum" in jst.sched else "pending"
    js = [np.asarray(x) for x in T.flatten_up_to(paths, jst.sched[slot])]
    ts = [x.numpy() for x in T.flatten_up_to(paths, tst.sched[slot])]
    assert [x.shape for x in ts] == [x.shape for x in js]
    mmax = max(np.abs(x).max() for x in js)
    # the slots hold η·g of fields evaluated at parameters that agree to
    # a flipped code (emax): 1e-3 of the message scale
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3 * mmax + emax)
    if slot == "pending":
        np.testing.assert_array_equal(tst.sched["versions"].numpy(),
                                      np.asarray(jst.sched["versions"]))


@pytest.mark.parametrize("comp", sorted(COMPRESSION))
def test_local_k1_is_every_step_bit_for_bit(comp):
    jstrat = JStrategy(compression=JComp(**COMPRESSION[comp]))
    _, every = trainers(jstrat)
    _, local1 = trainers(jstrat.evolve(schedule="local_k", local_k=1))
    params = TG.init(TCFG, generator=torch.Generator().manual_seed(0))
    sa, sb = every.init(params), local1.init(params)
    rs = np.random.RandomState(5)
    for t in range(4):
        real = torch.from_numpy(rs.randn(B, 2).astype(np.float32))
        sa = every.step(sa, {"real": real}).state
        sb = local1.step(sb, {"real": real}, do_exchange=True).state
    for name in ("params", "prev_grad", "ef"):
        for a, b in zip(T.leaves(getattr(sa, name)),
                        T.leaves(getattr(sb, name))):
            if a is None:
                assert b is None
            else:
                assert torch.equal(a, b), name
    assert not any(x.any() for x in T.leaves(sb.sched["accum"]))


def test_local_k_refuses_a_tensor_do_exchange():
    _, tr = trainers(JStrategy(schedule=JSched.local_k(2)))
    st = tr.init(TG.init(TCFG))
    with pytest.raises(TypeError, match="Python bool"):
        tr.step(st, {"real": torch.zeros((B, 2))},
                do_exchange=torch.tensor(True))


def test_mid_round_steps_leave_params_and_ef_alone():
    """Under local_k the EF residuals and the parameters move only on the
    round's last step; the accumulator grows in between."""
    jstrat = JStrategy(compression=JComp(**COMPRESSION["bucketed"]),
                       schedule=JSched.local_k(3))
    _, tr = trainers(jstrat)
    st = tr.init(TG.init(TCFG, generator=torch.Generator().manual_seed(1)))
    sched = tr.strategy.schedule.runtime()
    rs = np.random.RandomState(0)
    for t in range(6):
        real = torch.from_numpy(rs.randn(B, 2).astype(np.float32))
        new = tr.step(st, {"real": real},
                      do_exchange=sched.is_exchange_step(t)).state
        same_p = all(torch.equal(a, b) for a, b in
                     zip(T.leaves(st.params), T.leaves(new.params)))
        same_e = all(torch.equal(a, b) for a, b in
                     zip(T.leaves(st.ef), T.leaves(new.ef)))
        assert same_p == same_e == (not sched.is_exchange_step(t)), t
        st = new
