"""`repro_torch.obs.trace` (the counterpart of `repro.obs.hlo`) over 2 and 4
gloo ranks (`torch_ranks`), four workers of the mixture GAN, spans on:

  * `byte_gap` of one exchange step against the `CommLedger`, per kind.
    With W workers, L = W / world of them a rank, and a bucket's payload
    cb (int8 codes and float32 scales of one worker's d elements), each
    bucket's collectives hold on a rank: sim, one float32 all_reduce of
    4d bytes, the ledger's modeled result exactly (gap 0); allgather, the
    W workers' payloads gathered, W·cb against W²·cb / (2(W − 1)), gap
    (W − 2)/W = 0.5; two_phase, the L rows' full payloads through the
    all_to_all plus the owners' chunks gathered, (L + 1)·cb against cb,
    gap L (2 at world 2, 1 at world 4). The step's metric reductions
    run outside the exchange phase and are not counted;
  * a `local_k(2)` mid-round step calls no payload collective, its
    round end an all-reduce-class one (`assert_schedule_structure`);
  * under `delayed` with `overlap=True` the exchange's first collective
    starts before the field's first operator; blocking, it starts after;
  * the ranks' `metrics["obs"]` (metrics full; half reporting, the
    adaptive family, and the τ-vector) equal the stacked run's within
    `repro_torch.parity.obs_agreement`;
  * `check_fsdp_structure` passes an fsdp step (zero-3: two_phase's
    all_to_all of int8 codes, the shards' all-gather; exact: the
    reduce-scatter) and reports the violations of a replicated `exact`
    step (no scatter, no all-gather) and of an exact fsdp step held to
    the compressed rule (no int8 on the wire).
"""
import pytest

from repro_torch.parity import obs_agreement
from torch_ranks import fsdp_strategy, mixture_case, run_ranks, strategy_case
from torch_ranks import one_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)
KINDS = ("sim", "allgather", "two_phase")


def _trainer(case, mesh, **flags):
    from torch_ranks import _torch, make_trainer
    from repro_torch import tree as T
    from repro_torch.strategy import Strategy
    strat = Strategy.from_json(case["strategy"]).evolve(**flags)
    tr = make_trainer(dict(case, strategy=strat.to_json()), mesh)
    st = tr.init(T.unflatten(case["paths"],
                             [_torch(x) for x in case["params"]]))
    return tr, st, [{"real": _torch(b)} for b in case["batches"]]


def _step(tr, st, batch, **kw):
    from repro_torch.obs import trace
    return trace.capture(tr.step, st, batch, **kw)


def _ranks_main(mesh):
    """Every check's evidence from this rank (all ranks run the same)."""
    from repro_torch.obs import trace
    from repro_torch.strategy import Schedule
    out = {"gap": {}, "obs": {}}
    for kind in KINDS:
        tr, st, batches = _trainer(mixture_case(f"{kind}_full", False), mesh,
                                   obs_spans=True)
        st = tr.step(st, batches[0]).state
        _, prof = _step(tr, st, batches[1])
        gap = trace.byte_gap(prof, tr.comm_ledger(st.params))
        trace.assert_schedule_structure(tr.strategy.schedule, prof)
        out["gap"][kind] = dict(gap, n_buckets=len(
            tr._comm(st.params)[0].buckets), L=tr.n_local,
            all_collectives=trace.collective_summary(prof, None))
    # local_k(2): step 0 mid-round, step 1 the round's end
    tr, st, batches = _trainer(mixture_case("sim_full", False), mesh,
                               obs_spans=True, schedule="local_k", local_k=2)
    mid, mid_prof = _step(tr, st, batches[0], do_exchange=False)
    _, end_prof = _step(tr, mid.state, batches[1], do_exchange=True)
    out["local_k"] = trace.check_schedule_structure(
        Schedule.local_k(2), end_prof, mid_prof)
    bad = trace.check_schedule_structure(Schedule.local_k(2), end_prof,
                                         end_prof)
    out["local_k_leak"] = bad["violations"]
    # delayed(2) two_phase, overlap on and off
    for ov in (True, False):
        tr, st, batches = _trainer(
            mixture_case("two_phase_delayed2", False, overlap=ov), mesh,
            obs_spans=True)
        st = tr.step(st, batches[0]).state
        _, prof = _step(tr, st, batches[1])
        out[f"overlap_{ov}"] = trace.check_schedule_structure(
            tr.strategy.schedule, prof, overlap=True)
    # fsdp against replicated exact
    from repro_torch.strategy import Compression, ExchangePlan, Strategy
    replicated = Strategy(
        compression=Compression(compressor="identity", error_feedback=False,
                                plan="uniform", bucket_mb=0.03),
        exchange=ExchangePlan(kind="exact", worker_axes=("data",)))
    out["fsdp"] = {}
    for label, strat in (
            ("zero3", fsdp_strategy(3)),
            ("exact_zero3", fsdp_strategy(3, kind="exact",
                                          moments="identity")),
            ("replicated_exact", replicated)):
        tr, st, batches = _trainer(strategy_case(strat), mesh,
                                   obs_spans=True)
        st = tr.step(st, batches[0]).state
        _, prof = _step(tr, st, batches[1])
        out["fsdp"][label] = {c: trace.check_fsdp_structure(prof, c)
                              for c in (False, True)}
    # metrics["obs"], full, every step
    for name in ("sim_adaptive", "sim_adaptive_tau_vector"):
        case = mixture_case(name, True, steps=4)
        out["obs"][name] = _obs_run(case, mesh)
    return out


def _obs_run(case, mesh=None):
    from torch_ranks import _torch
    tr, st, batches = _trainer(case, mesh, obs_metrics="full")
    rows = []
    for t, b in enumerate(batches):
        res = tr.step(st, b, _torch(case["draws"][t]))
        st = res.state
        rows.append({k: v.tolist() for k, v in res.metrics["obs"].items()})
    return rows


@pytest.fixture(scope="module")
def ranks():
    return {w: run_ranks(_ranks_main, w, timeout=240) for w in WORLDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", WORLDS)
def test_byte_gap_against_the_ledger(ranks, world, kind):
    W = 4
    for r in ranks[world]:
        g = r["gap"][kind]
        L = g["L"]
        assert L == W // world
        want = {"sim": 0.0, "allgather": (W - 2) / W, "two_phase": L}[kind]
        assert g["gap_ratio"] == pytest.approx(want, abs=1e-12), g
        # one all_reduce a bucket (sim); the payload entries gathered
        # (codes + scales, allgather); both through all_to_all and the
        # owners' chunks gathered (two_phase)
        colls = g["collectives"]
        nb = g["n_buckets"]
        if kind == "sim":
            assert colls == {"all-reduce": {
                "count": nb, "bytes": g["measured_bytes"],
                "int8_bytes": 0}}
        elif kind == "allgather":
            assert list(colls) == ["all-gather"]
            assert colls["all-gather"]["count"] == 2 * nb
            assert colls["all-gather"]["int8_bytes"] > 0
        else:
            assert colls["all-to-all"]["count"] == 2 * nb
            assert colls["all-gather"]["count"] == 2 * nb
        # the metric reductions: all_reduces outside the exchange phase
        extra = g["all_collectives"]["all-reduce"]["count"] - colls.get(
            "all-reduce", {"count": 0})["count"]
        assert extra >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_local_k_mid_round_step_calls_no_payload(ranks, world):
    for r in ranks[world]:
        rep = r["local_k"]
        assert rep["ok"], rep["violations"]
        assert rep["midround_class_totals"]["int8_bytes"] == 0
        assert rep["midround_largest_bytes"] < 64
        assert rep["exchange_class_totals"]["count"] >= 1
        # the round's end held against itself is a leak, and says so
        assert any("leaking" in v for v in r["local_k_leak"])


@pytest.mark.parametrize("world", WORLDS)
def test_overlap_starts_the_exchange_before_the_field(ranks, world):
    for r in ranks[world]:
        on, off = r["overlap_True"], r["overlap_False"]
        assert on["ok"], on["violations"]
        assert not off["ok"]
        assert any("not before the field" in v for v in off["violations"])


@pytest.mark.parametrize("name", ["sim_adaptive", "sim_adaptive_tau_vector"])
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_obs_equal_the_stacked_obs(ranks, world, name):
    stacked = _obs_run(mixture_case(name, True, steps=4))
    got = ranks[world][0]["obs"][name]
    assert len(got) == len(stacked) == 4
    for t, (a, b) in enumerate(zip(stacked, got)):
        assert not obs_agreement(a, b), (t, obs_agreement(a, b))
    for r in ranks[world][1:]:
        assert r["obs"][name] == got       # every rank holds the fleet's


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_structure_separates_fsdp_from_replicated(ranks, world):
    for r in ranks[world]:
        rep = r["fsdp"]
        z3 = rep["zero3"][True]
        assert z3["ok"], z3["violations"]
        # two_phase's reduce-scatter is an all_to_all of codes and scales
        assert z3["collectives"]["all-to-all"]["int8_bytes"] > 0
        assert z3["all_gather_ops"] >= 1 and z3["int8_bytes"] > 0
        ex = rep["exact_zero3"]
        assert ex[False]["ok"], ex[False]["violations"]
        assert ex[False]["collectives"]["reduce-scatter"]["count"] >= 1
        assert not ex[True]["ok"]
        assert any("int8" in v for v in ex[True]["violations"])
        repl = rep["replicated_exact"][False]
        assert not repl["ok"]
        assert any("no scatter" in v for v in repl["violations"])
        assert any("no all-gather" in v for v in repl["violations"])
