"""`exchange.overlap` in the port: under `delayed(τ)` the wire carries the
pending ring's head, known before the round's field, so the exchange
starts before the extrapolation and the field (on a second CUDA stream on
the card; in line on the CPU) and finishes after it
(`core.dqgan.DQGAN._start_overlapped`).

  * overlap on ≡ off, bit for bit, every leaf of the state and every
    metric: one worker under τ ∈ {1, 2, 4} (per-leaf) and bucketed
    two_phase (τ = 2); four workers stacked and over 2 gloo ranks × 2
    (two_phase, and sim with the τ-vector (1, 2, 3, 4), half reporting,
    the adaptive family), with the generators' draws and with injected
    ones;
  * the schedules whose message is made in the round (every_step,
    local_k) exchange in the blocking order under the flag;
  * the refusals stay: overlap with spmd='vmap' or exchange='exact' is
    not a strategy; fsdp and spmd='vmap' are refused by the trainer,
    each naming its slice (observability now runs with overlap); an overlapped step refuses a
    field that draws from its generator without exposing `draw_z`;
  * one delayed overlap run against the JAX package's one-device run of
    the bilinear game (its tests/test_overlap.py `_run_state`), the JAX
    draws replayed: params − e1 to float32 rounding, params within a
    quantization step.
"""
import numpy as np
import pytest
import torch

from repro_torch.strategy import (Compression, ExchangePlan, Schedule,
                                  Strategy, StrategyError)
from torch_ranks import MIX, mixture_case, run_case, run_cases, run_ranks
from torch_ranks import one_thread  # noqa: F401 (autouse)

STEPS = 6


def _one_worker_case(strat, inject=False, steps=STEPS, seed=2):
    from repro_torch import tree as T
    from repro_torch.models import gan as TG
    params = TG.init(TG.GANConfig(**MIX),
                     generator=torch.Generator().manual_seed(0))
    paths, leaves = T.flatten(params)
    rs = np.random.RandomState(seed)
    case = dict(strategy=strat.to_json(), W=1, paths=paths,
                params=[x.numpy() for x in leaves], seed=seed,
                batches=[rs.randn(16, 2).astype(np.float32)
                         for _ in range(steps)])
    if inject:
        case["draws"] = [{"z": rs.randn(16, MIX["latent_dim"]).astype(
            np.float32)} for _ in range(steps)]
    return case


def _pair(make):
    """(overlap off, overlap on) results of the case `make(overlap)`."""
    return run_case(make(False)), run_case(make(True))


def assert_bit_equal(off, on):
    assert list(off["state"]) == list(on["state"])
    for k, a in off["state"].items():
        np.testing.assert_array_equal(on["state"][k], a, err_msg=k)
    assert off["metrics"] == on["metrics"]


ONE_WORKER = {
    f"delayed{tau}": dict(schedule=Schedule.delayed(tau))
    for tau in (1, 2, 4)}
ONE_WORKER["two_phase_bucketed_delayed2"] = dict(
    compression=Compression(compressor="qsgd8_block1024", plan="uniform",
                            bucket_mb=0.003),
    schedule=Schedule.delayed(2), kind="two_phase")


def _one(name, overlap, inject):
    kw = dict(ONE_WORKER[name])
    kind = kw.pop("kind", "sim")
    return _one_worker_case(Strategy(
        exchange=ExchangePlan(kind=kind, worker_axes=(), overlap=overlap),
        **kw), inject)


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("name", sorted(ONE_WORKER))
def test_one_worker_overlap_is_bit_exact(name, inject):
    off, on = _pair(lambda ov: _one(name, ov, inject))
    assert_bit_equal(off, on)
    assert on["metrics"][-1]["staleness_max"] == float(
        Strategy.from_json(_one(name, True, inject)["strategy"])
        .schedule.tau)


FOUR = ("two_phase_delayed2", "sim_adaptive_tau_vector")


def _four(name, overlap, inject):
    return mixture_case(name, inject, steps=STEPS, overlap=overlap)


FOUR_CASES = [(n, inject) for n in FOUR for inject in (False, True)]


@pytest.mark.parametrize("name,inject", FOUR_CASES)
def test_four_stacked_workers_overlap_is_bit_exact(name, inject):
    assert_bit_equal(*_pair(lambda ov: _four(name, ov, inject)))


@pytest.fixture(scope="module")
def two_ranks():
    cases = [_four(n, ov, inject) for n, inject in FOUR_CASES
             for ov in (False, True)]
    return run_ranks(run_cases, 2, cases, timeout=180)[0]


@pytest.mark.parametrize("name,inject", FOUR_CASES)
def test_two_ranks_overlap_is_bit_exact(two_ranks, name, inject):
    i = FOUR_CASES.index((name, inject))
    off, on = two_ranks[2 * i], two_ranks[2 * i + 1]
    assert_bit_equal(off, on)


@pytest.mark.parametrize("schedule", [Schedule.every_step(),
                                      Schedule.local_k(2)])
def test_round_made_messages_exchange_in_the_blocking_order(schedule):
    """every_step and local_k exchange a message of the round's own field,
    so the flag changes nothing there."""
    assert not schedule.overlappable
    off, on = _pair(lambda ov: _one_worker_case(Strategy(
        exchange=ExchangePlan(worker_axes=(), overlap=ov),
        schedule=schedule)))
    assert_bit_equal(off, on)


@pytest.mark.parametrize("overlap", [False, True])
def test_a_field_that_draws_without_draw_z_is_refused_overlapped(overlap):
    """The exchange would take its draws ahead of such a field's, not
    after them as it does blocking: the overlapped step raises."""
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.configs.base import DQConfig

    def field(params, batch, z=None, generator=None):
        noise = torch.rand(params["x"].shape, generator=generator)
        return {"x": params["x"] + noise}, {"loss": params["x"].sum()}

    strat = Strategy(schedule=Schedule.delayed(2),
                     exchange=ExchangePlan(worker_axes=(), overlap=overlap))
    tr = DQGAN(field_fn=field, device="cpu", dq=DQConfig.from_strategy(
        strat, optimizer="omd", lr=0.05))
    st = tr.init({"x": torch.ones(6)})
    if not overlap:
        assert tr.step(st, {"real": torch.zeros(1, 1)}).state.step == 1
        return
    with pytest.raises(RuntimeError, match="draw_z"):
        tr.step(st, {"real": torch.zeros(1, 1)})


def test_overlap_strategies_refused_stay_refused():
    with pytest.raises(StrategyError, match=r"exchange\.overlap"):
        ExchangePlan(spmd="vmap", overlap=True)
    with pytest.raises(StrategyError, match=r"exchange\.overlap"):
        ExchangePlan(kind="exact", overlap=True)
    with pytest.raises(StrategyError, match=r"exchange\.overlap"):
        ExchangePlan(overlap=1)


# every feature beside overlap is ported (slice 4's observability, slice
# 5's fsdp and vmap): each constructs; vmap alone refuses a process mesh,
# as the JAX package's vmap step has no collectives of its own
@pytest.mark.parametrize("preset,flags", [
    ("fsdp_zero3", {}),
    ("fsdp_vmap", {}),
    ("overlap", {"obs_metrics": "wire"}),
])
def test_trainer_still_refuses_the_other_features(preset, flags):
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.strategy import get_preset
    strat = get_preset(preset).evolve(**flags)
    tr = DQGAN(field_fn=None, strategy=strat, device="cpu")
    if preset == "overlap":
        assert tr.strategy.exchange.overlap and tr.obs_spec.name == "wire"
    elif preset == "fsdp_zero3":
        assert tr.fsdp and tr.strategy.exchange.zero_stage == 3
    else:
        with pytest.raises(ValueError, match="stacked workers only"):
            DQGAN(field_fn=None, strategy=strat, device="cpu", workers=4,
                  mesh=object())


def test_delayed_overlap_matches_the_jax_one_device_run():
    """The JAX package's tests/test_overlap.py::_run_state (the bilinear
    game, one device, omd at lr 0.05, delayed(2), overlap on), against
    the port's overlapped run with the JAX step's draws replayed."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import DQConfig as JDQ
    from repro.core.dqgan import DQGAN as JDQGAN
    from repro.strategy import ExchangePlan as JEx
    from repro.strategy import Schedule as JSched
    from repro.strategy import Strategy as JStrategy
    from torch_ranks import BILINEAR_A

    A = jnp.asarray(BILINEAR_A["overlap"])

    def bilinear(params, batch, rng):
        x, y = params["x"], params["y"]
        return {"x": A @ y, "y": -(A.T @ x)}, {"loss": x @ A @ y}

    jstrat = JStrategy(schedule=JSched.delayed(2),
                       exchange=JEx(worker_axes=(), overlap=True))
    jtr = JDQGAN(field_fn=bilinear,
                 dq=JDQ.from_strategy(jstrat, optimizer="omd", lr=0.05))
    key = jax.random.key(0)
    jst = jtr.init({"x": jnp.ones(6), "y": jnp.ones(6)})
    step = jax.jit(jtr.step, static_argnums=(3,))
    draws = []
    comp = jtr.compressor
    for t in range(STEPS):
        _, kq = jax.random.split(jax.random.fold_in(key, t))
        b = comp.per_block
        draws.append({"rand": {i: np.asarray(jax.random.uniform(
            jax.random.fold_in(kq, i), (1, 6) if b <= 0 else (-(-6 // b), b)))
            for i in range(2)}})
        jst = step(jst, None, key, True).state
    jst = jax.device_get(jst)
    tstrat = Strategy.from_json(jstrat.to_json())
    case = dict(strategy=tstrat.to_json(), W=1, field="bilinear_overlap",
                paths=[("x",), ("y",)], params=[np.ones(6, np.float32)] * 2,
                batches=[np.zeros((1, 1), np.float32)] * STEPS, lr=0.05,
                draws=draws)
    got = run_case(case)["state"]
    assert got["step"] == STEPS == int(jst.step)
    for k in ("x", "y"):
        jp, je = np.asarray(jst.params[k]), np.asarray(jst.ef[k]["e1"])
        tp, te = got[f"params/{k}"], got[f"ef/{k}/e1"]
        emax = np.abs(je).max()
        np.testing.assert_allclose(tp - te.sum(0), jp - je.sum(0), rtol=0,
                                   atol=1e-6 + 1e-6 * 127 * emax)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6 + emax)
    np.testing.assert_array_equal(got["sched/versions"],
                                  np.asarray(jst.sched["versions"]))
