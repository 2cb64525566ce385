"""`repro_torch.obs` against `repro.obs` on the CPU: the metrics, the step's
telemetry, the off contract and the run sinks.

  * `MetricSpec`, `metric_keys`, `Collector` + `finalize`, the staleness
    histogram and the EF norms on the same numpy inputs as the JAX
    package's: rtol 1e-6;
  * `metrics["obs"]` of the port's step against the JAX step's, the JAX
    draws replayed, every step: one worker over packed B1 buckets
    (`dqgan_bucketed`, the one-launch exchange) and per-leaf qsgd8_linf
    (the five-step harness of tests/test_torch_dqgan.py); the four-worker
    runs (half reporting under the adaptive family, every step and under
    delayed with the τ-vector) are compared by the same helpers in
    tests/test_torch_multiworker.py, whose one JAX subprocess records
    them with obs full. Moments and EF norms: rtol 1e-5; the
    staleness histogram: exact; δ̂ and bucket_delta as the residual
    ratio 1 − δ̂ = Σe'²/Σm², relative to itself, within the bound
    `_delta_bound` derives from `repro_torch.parity`'s at most 1e-3
    flipped codes, computed from each step's operands and residuals
    (plus float32 rounding of δ̂ next to 1), and the largest |Δδ̂| over
    a run at most 1e-6 (6e-8, one float32 ulp, seen; a flip at 127
    levels moves δ̂ by about 1e-6, a lost half of Σe'² by about 1e-4);
  * the off contract: off, wire and full trajectories (and full with
    spans and the step profiler on) bit-equal, one worker and four; an
    off step runs the same aten operators as a step under the profiler;
  * sinks: `repro.obs.validate_event` accepts every event of a port sink;
    ``report --json`` and ``calibrate --json`` of both packages are
    byte-identical on a port sink and on a JAX sink; the trainer's
    stdout without obs flags is its log rows and header lines alone.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as JOBS
from repro_torch import obs as TOBS
from repro_torch import tree as T
from repro_torch.core import compressors as TC
from repro_torch.parity import DELTA_ROUNDING, MAX_FLIPPED
from torch_ranks import one_thread  # noqa: F401 (autouse)

# --------------------------------------------------------------------------- #
# the metrics module on the same inputs
# --------------------------------------------------------------------------- #
LEVELS = ("off", "wire", "full")


@pytest.mark.parametrize("level", LEVELS)
def test_metric_specs_and_keys_match_jax(level):
    j, t = JOBS.METRIC_SPECS[level], TOBS.METRIC_SPECS[level]
    assert (j.name, j.moments, j.delta, j.ef_norms, j.staleness, j.on) == \
        (t.name, t.moments, t.delta, t.ef_norms, t.staleness, t.on)
    for nb in (0, 3):
        assert TOBS.metric_keys(t, nb) == JOBS.metric_keys(j, nb)


def _inputs(seed=0):
    """(raw, op, err) of three buckets and a leaf, at three scales: the
    residual a hundredth of the operand, as a quantizer leaves it."""
    rs = np.random.RandomState(seed)
    scale = (1.0, 1.0, 0.01)
    buckets = [[(rs.randn(n) * s * f).astype(np.float32) for f in scale]
               for n, s in ((2048, 1.0), (1024, 1e-3), (4096, 30.0))]
    leaf = [(rs.randn(5, 7) * f).astype(np.float32) for f in scale]
    return buckets, leaf


@pytest.mark.parametrize("level", LEVELS[1:])
def test_collector_and_finalize_match_jax(level):
    """Three buckets (one recorded twice over), a leaf and W = 4: the sums
    and the finalized dict, rtol 1e-6."""
    buckets, leaf = _inputs()
    jc = JOBS.Collector(JOBS.METRIC_SPECS[level], 4)
    tc = TOBS.Collector(TOBS.METRIC_SPECS[level], 4)
    t1 = lambda x: torch.from_numpy(x)[None]     # one worker's row
    for bid, (raw, op, err) in enumerate(buckets):
        jc.bucket(bid, raw, op, err)
        tc.bucket(bid, t1(raw), t1(op), t1(err))
    jc.leaf(*leaf)
    tc.leaf(*[t1(x) for x in leaf])
    assert tc.counts() == jc.counts()
    js, ts = jc.sums(), tc.sums()
    assert list(ts) == list(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, err_msg=k)
    extra = {"e1_sq": 2.5, "e2_sq": 0.0,
             "staleness_hist": np.array([1.0, 2.0, 1.0], np.float32)}
    jf = JOBS.finalize(JOBS.METRIC_SPECS[level], {**js, **extra},
                       jc.counts(), 4, 4)
    tf = TOBS.finalize(TOBS.METRIC_SPECS[level],
                       {**ts, **{k: torch.as_tensor(v, dtype=torch.float32)
                                 for k, v in extra.items()}},
                       tc.counts(), 4, 4)
    assert list(tf) == list(jf)
    for k in jf:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)


def test_null_collector_and_zero_denominators_match_jax():
    spec = "full"
    jf = JOBS.finalize(JOBS.METRIC_SPECS[spec], {
        **JOBS.Collector(JOBS.METRIC_SPECS[spec], 2).sums(),
        "e1_sq": 0.0, "e2_sq": 0.0, "staleness_hist": np.zeros(2)},
        {"agg": 0, "bucket": [0, 0]}, 1, 2)
    tf = TOBS.finalize(TOBS.METRIC_SPECS[spec], {
        **TOBS.Collector(TOBS.METRIC_SPECS[spec], 2).sums(),
        "e1_sq": torch.zeros(()), "e2_sq": torch.zeros(()),
        "staleness_hist": torch.zeros(2)}, {"agg": 0, "bucket": [0, 0]}, 1, 2)
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), k)
    null = TOBS.NullCollector()
    assert not null.enabled and null.sums() == {}
    assert null.counts() == JOBS.NullCollector().counts()


def test_staleness_hist_and_ef_norms_match_jax():
    st = np.array([0.0, 1.0, 2.0, 5.0, 1.4], np.float32)
    np.testing.assert_array_equal(
        TOBS.staleness_hist(torch.from_numpy(st), 4).numpy(),
        np.asarray(JOBS.staleness_hist(st, 4)))
    np.testing.assert_array_equal(
        TOBS.staleness_hist(torch.tensor(0.0), 3).numpy(),
        np.asarray(JOBS.staleness_hist(np.float32(0.0), 3)))
    rs = np.random.RandomState(1)
    tree = {"leaf": {"a": {"e1": rs.randn(3, 4).astype(np.float32)},
                     "b": {"w": {"e1": rs.randn(8).astype(np.float32)}}},
            "bucket": {"0": {"e2": rs.randn(16).astype(np.float32)}}}
    ttree = jax.tree.map(torch.from_numpy, tree)
    for a, b in zip(TOBS.ef_norms_sq(ttree), JOBS.ef_norms_sq(tree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(TOBS.ef_norms_sq(None), JOBS.ef_norms_sq(None)):
        assert float(a) == float(b) == 0.0


# --------------------------------------------------------------------------- #
# the step's telemetry against the JAX step's
# --------------------------------------------------------------------------- #
class _Spy:
    """Keeps what every `Collector.bucket`/`leaf` call saw, (stream id or
    None, the operand m and the residual e' as float64), for the δ̂
    bound."""

    def __init__(self, monkeypatch):
        self.calls = []
        for kind in ("bucket", "leaf"):
            orig = getattr(TOBS.Collector, kind)

            def rec(col, *a, _orig=orig, _kind=kind):
                sid = a[0] if _kind == "bucket" else None
                self.calls.append((sid, a[-2].double().numpy().copy(),
                                   a[-1].double().numpy().copy()))
                return _orig(col, *a)
            monkeypatch.setattr(TOBS.Collector, kind, rec)

    def step(self):
        out, self.calls = self.calls, []
        return out


def _delta_bound(calls, levels, block):
    """The largest relative change of the residual ratio 1 − δ̂ = Σe'²/Σm²
    (aggregate, and per bucket) that at most MAX_FLIPPED of the elements
    quantized one level apart can make.

    A flipped element's residual e' moves by one step s/L of its scale
    block (s the block's max|m|), and |e'| < s/L before and after, so
    Σe'² moves by at most (s/L)² for it. With F = MAX_FLIPPED · n flips
    among the exchange's n elements, |ΔΣe'²| is at most the sum of the F
    largest (s/L)² over the elements (over a bucket's own elements, for
    its bucket_delta), and Σe'²/Σm² moves by that over Σe'², relative to
    itself. `levels` maps a bucket id (None: a leaf) to its level count
    L; `block` is the quantizer's scale block (0: the whole tensor)."""
    steps2, per, total_err = [], {}, 0.0
    for sid, op, err in calls:
        rows = op.reshape(op.shape[0], -1)
        b = block or rows.shape[1]
        s = np.abs(rows.reshape(-1, b)).max(axis=1) / levels[sid]
        s2 = np.repeat(s * s, b)
        steps2.append(s2)
        esq = float((err * err).sum())
        total_err += esq
        if sid is not None:
            per[sid] = (s2, esq)
    allsteps = np.sort(np.concatenate(steps2))[::-1]
    F = int(MAX_FLIPPED * allsteps.size)
    agg = allsteps[:F].sum() / max(total_err, 1e-30)
    return agg, {sid: np.sort(s2)[::-1][:F].sum() / max(esq, 1e-30)
                 for sid, (s2, esq) in per.items()}


def _residual_close(got, ref, rtol):
    """|Δ(1 − δ̂)| within `rtol` of the reference's 1 − δ̂, plus float32
    rounding of δ̂ next to 1 (`parity.DELTA_ROUNDING`). Returns |Δδ̂|."""
    r_ref, r_got = 1.0 - ref, 1.0 - got
    assert abs(r_got - r_ref) <= rtol * abs(r_ref) + DELTA_ROUNDING, (
        got, ref, rtol)
    return abs(got - ref)


def _assert_obs_close(jo, to, bound, label):
    """The port's obs dict against the JAX one: moments and EF norms rtol
    1e-5, the histogram exactly, δ̂ and bucket_delta as 1 − δ̂ within the
    flip bound (`_delta_bound`). Returns the largest |Δδ̂|."""
    agg, per = bound
    worst = 0.0
    nb = len(to["bucket_delta"]) if "bucket_delta" in to else 0
    assert tuple(to) == TOBS.metric_keys(TOBS.METRIC_SPECS["full"], nb)
    assert sorted(to) == sorted(jo), label
    for k in jo:
        a, b = np.asarray(jo[k], np.float64), to[k].double().numpy()
        if k == "staleness_hist":
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {k}")
        elif k == "delta_hat":
            worst = max(worst, _residual_close(float(b), float(a), agg))
        elif k == "bucket_delta":
            for i, (x, y) in enumerate(zip(b, a)):
                worst = max(worst, _residual_close(x, y, per[i]))
        else:
            scale = np.abs(a).max() if a.size else 0.0
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=f"{label} {k}")
    return worst


SINGLE = ("dqgan_bucketed", "dqgan_per_leaf")


def _full(strategy_json):
    d = json.loads(strategy_json)
    d["observability"] = {"metrics": "full", "spans": False,
                          "profile": False}
    return json.dumps(d)


@pytest.mark.parametrize("name", SINGLE)
def test_single_worker_obs_matches_jax(name, monkeypatch):
    """Five steps of the one-worker step, obs full on both sides, the JAX
    step's draws replayed: every step's metrics["obs"] by
    `_assert_obs_close`."""
    import test_torch_dqgan as H
    from repro.configs.base import DQConfig as JDQ
    from repro.core.dqgan import DQGAN as JDQGAN
    from repro.models import gan as JG
    from repro.strategy import Compression, ExchangePlan, Observability
    from repro.strategy import Strategy as JStrategy
    from repro_torch.configs.base import DQConfig as TDQ
    from repro_torch.convert import params_from_jax
    from repro_torch.core.dqgan import DQGAN as TDQGAN
    from repro_torch.models import gan as TG
    from repro_torch.strategy import Strategy as TStrategy

    comp_kw, kind, optim, extrap, lr = H.RUNS[name]
    jstrat = JStrategy(compression=Compression(**comp_kw),
                       exchange=ExchangePlan(kind=kind),
                       observability=Observability(metrics="full"))
    kw = dict(optimizer=optim, lr=lr, extrapolation=extrap, message="update")
    jtr = JDQGAN(field_fn=JG.gan_field_fn(H.CFG),
                 dq=JDQ.from_strategy(jstrat, **kw))
    ttr = TDQGAN(field_fn=TG.gan_field_fn(H.TCFG), device="cpu",
                 dq=TDQ.from_strategy(TStrategy.from_json(jstrat.to_json()),
                                      **kw))
    params = JG.init(jax.random.key(0), H.CFG)
    jst = jtr.init(params)
    tst = ttr.init(params_from_jax(jax.device_get(params)))
    step = jax.jit(jtr.step)
    key = jax.random.key(42)
    if ttr.bucketed:
        layout, cplan = ttr._comm(tst.params)
        levels = {b.bid: TC.get(a.compressor).levels
                  for b, a in zip(layout.buckets, cplan.assignments)}
    else:
        levels = {None: ttr.compressor.levels}
    block = ttr.compressor.per_block
    spy = _Spy(monkeypatch)
    worst = 0.0
    for t in range(H.STEPS):
        real = H._batch(t)
        jout = step(jst, {"real": real}, key)
        tout = ttr.step(tst, {"real": torch.from_numpy(np.array(real))},
                        H._replay_draws(jtr, params, key, t))
        jst, tst = jout.state, tout.state
        bound = _delta_bound(spy.step(), levels, block)
        worst = max(worst, _assert_obs_close(
            jax.device_get(jout.metrics["obs"]), tout.metrics["obs"], bound,
            f"{name} step {t}"))
    assert worst <= 1e-6, worst


# --------------------------------------------------------------------------- #
# the off contract
# --------------------------------------------------------------------------- #
def _dcgan_case(strategy, steps=3):
    """A torch_ranks case of the reduced dcgan32, one worker, batch 8."""
    from repro_torch.configs import get
    from repro_torch.data import procedural_images
    from repro_torch.models import gan
    cfg = get("dcgan32").reduced()
    params = gan.init(cfg, generator=torch.Generator().manual_seed(0))
    paths, leaves = T.flatten(params)
    gen = torch.Generator().manual_seed(5)
    return dict(strategy=strategy.to_json(), W=1, paths=paths,
                params=[x.numpy() for x in leaves],
                cfg={f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
                batches=[procedural_images(8, cfg.image_size, cfg.channels,
                                           generator=gen).numpy()
                         for _ in range(steps)], seed=3)


def _off_cases():
    from repro_torch.strategy import (Compression, ExchangePlan, Schedule,
                                      Strategy)
    from torch_ranks import mixture_case
    return {
        # one worker, packed B1 (plain on the CPU), delayed(2) overlapped
        "one_worker_packed_b1": lambda: _dcgan_case(Strategy(
            compression=Compression(compressor="qsgd8_block1024",
                                    plan="uniform"),
            schedule=Schedule.delayed(2),
            exchange=ExchangePlan(overlap=True))),
        # one worker per leaf, local_k(2): mid-round steps record nothing
        "one_worker_per_leaf_local_k": lambda: _dcgan_case(Strategy(
            compression=Compression(compressor="qsgd8_linf"),
            schedule=Schedule.local_k(2)), steps=4),
        # four workers stacked, half reporting, adaptive, τ-vector
        "four_workers_tau_vector": lambda: mixture_case(
            "sim_adaptive_tau_vector", False, steps=4),
        "four_workers_two_phase_delayed2_overlap": lambda: mixture_case(
            "two_phase_delayed2", False, steps=4, overlap=True),
    }


def _run_obs(case, level, spans=False, profile=False):
    """Train `case` (a torch_ranks case) at obs `level`; returns (final
    named state, per-step metrics without obs, per-step obs)."""
    from torch_ranks import _named, _torch, make_trainer
    from repro_torch.strategy import Strategy
    strat = Strategy.from_json(case["strategy"]).evolve(
        obs_metrics=level, obs_spans=spans)
    tr = make_trainer(dict(case, strategy=strat.to_json()))
    st = tr.init(T.unflatten(case["paths"],
                             [_torch(x) for x in case["params"]]))
    rt = tr.strategy.schedule.runtime()
    prof = TOBS.make_profiler(profile, window=len(case["batches"]),
                              device_phases=spans)
    rows, obs = [], []
    for t, real in enumerate(case["batches"]):
        with prof.phase("step"):
            out = tr.step(st, {"real": _torch(real)},
                          do_exchange=rt.is_exchange_step(t))
        prof.record_step(t, 0.01)
        st = out.state
        rows.append({k: float(v) for k, v in out.metrics.items()
                     if k != "obs"})
        obs.append(out.metrics.get("obs"))
    return _named(st), rows, obs, prof


@pytest.mark.parametrize("name", sorted(_off_cases()))
def test_off_wire_full_trajectories_bit_equal(name):
    """Parameters, EF, every state member and every metric row bit-equal
    across off, wire and full, and full with spans and the step profiler
    (a torch.profiler capture) on."""
    case = _off_cases()[name]()
    ref, ref_rows, ref_obs, _ = _run_obs(case, "off")
    assert all(o is None for o in ref_obs)
    for level, spans, profile in (("wire", False, False),
                                  ("full", False, False),
                                  ("full", True, True)):
        got, rows, obs, prof = _run_obs(case, level, spans, profile)
        assert list(got) == list(ref)
        for k, a in ref.items():
            b = got[k]
            assert (np.array_equal(a, b) and a.dtype == b.dtype
                    if isinstance(a, np.ndarray) else a == b), (level, k)
        assert rows == ref_rows, level
        assert all(list(o) == list(obs[0]) for o in obs)
        if profile:
            ph = prof.summary()
            assert ph["n_steps"] == len(case["batches"])
            assert {"field", "compress", "exchange", "apply"} <= set(
                ph["device_phases"]), ph.get("device_phases")


def test_an_off_step_runs_the_aten_ops_of_a_profiled_step():
    """The same aten operators, in the same order, with and without the
    step profiler's capture running around the step."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch_ranks import _torch, make_trainer
    case = _off_cases()["one_worker_packed_b1"]()

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    seqs = []
    for profile in (False, True):
        tr = make_trainer(case)
        st = tr.init(T.unflatten(case["paths"],
                                 [_torch(x) for x in case["params"]]))
        prof = TOBS.make_profiler(profile, window=3, device_phases=True)
        st = tr.step(st, {"real": _torch(case["batches"][0])}).state
        prof.record_step(0, 0.01)      # starts the capture (profile on)
        with Ops() as mode:
            tr.step(st, {"real": _torch(case["batches"][1])})
        prof.record_step(1, 0.01)
        prof.emit(TOBS.NullSink())
        seqs.append(mode.ops)
    assert seqs[0] and seqs[0] == seqs[1]


# --------------------------------------------------------------------------- #
# sinks
# --------------------------------------------------------------------------- #
PORT_ARGS = ["--arch", "dcgan32", "--smoke", "--steps", "4", "--optimizer",
             "omd", "--compressor", "qsgd8_block1024", "--comm-plan",
             "uniform", "--obs-metrics", "full", "--obs-spans",
             "--profile-steps", "3"]


@pytest.fixture(scope="module")
def sinks(tmp_path_factory):
    """A port sink (the trainer's CLI, three runs: every_step, and the
    delayed(2) pair with overlap off and on) and a JAX sink (its
    launcher, one run)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    root = tmp_path_factory.mktemp("sinks")
    port = root / "port.jsonl"
    parts = []
    for i, extra in enumerate(([], ["--schedule", "delayed",
                                    "--staleness-tau", "2"],
                               ["--schedule", "delayed", "--staleness-tau",
                                "2", "--overlap"])):
        p = root / f"port{i}.jsonl"
        ttrain.main(PORT_ARGS + ["--device", "cpu", "--obs-sink", str(p)]
                    + extra)
        parts.append(p.read_text())
    port.write_text("".join(parts))
    jax_sink = root / "jax.jsonl"
    jtrain.main(["--arch", "dcgan32", "--smoke", "--steps", "3",
                 "--log-every", "1", "--compressor", "qsgd8_block1024",
                 "--comm-plan", "uniform", "--obs-metrics", "full",
                 "--profile-steps", "2", "--obs-sink", str(jax_sink)])
    return {"port": str(port), "jax": str(jax_sink)}


def test_port_sink_validates_in_the_jax_package(sinks):
    events = JOBS.read_events(sinks["port"])
    kinds = [e["kind"] for e in events]
    for kind in ("run_meta", "train_log", "timing", "obs_metrics",
                 "comm_summary", "profile"):
        assert kind in kinds, kind
    assert kinds.count("run_meta") == 3
    for e in events:
        JOBS.validate_event(e)
        assert e["v"] == JOBS.SCHEMA_VERSION
    prof = [e for e in events if e["kind"] == "profile"][0]
    assert {"field", "compress", "exchange", "apply"} <= set(
        prof["device_phases"])
    obs = [e for e in events if e["kind"] == "obs_metrics"][-1]
    assert len(obs["bucket_delta"]) == 1 and 0 < obs["delta_hat"] <= 1


@pytest.mark.parametrize("cmd", ["report", "calibrate"])
@pytest.mark.parametrize("which", ["port", "jax"])
def test_both_packages_render_a_sink_byte_identically(sinks, which, cmd,
                                                      capsys, tmp_path):
    """``python -m repro.obs`` and ``python -m repro_torch.obs``, --json and
    --out, on the same sink: the same bytes."""
    from repro.obs import __main__ as jmain
    from repro_torch.obs import __main__ as tmain
    outs = []
    for i, main in enumerate((jmain, tmain)):
        out = tmp_path / f"{i}.json"
        assert main.main([cmd, sinks[which], "--json", "--out",
                          str(out)]) == 0
        outs.append((capsys.readouterr().out, out.read_text()))
    assert outs[0] == outs[1]
    payload = json.loads(outs[0][1])
    if cmd == "report" and which == "port":
        assert payload["profile"]["device_phases"]["compress"]["ops"] > 0
        assert len(payload["overlap"]) == 1
    if cmd == "calibrate":
        from repro_torch.sched.clock import load_calibration
        load_calibration(str(tmp_path / "1.json"))


def test_trainer_stdout_without_obs_flags_is_unchanged(capsys):
    """No obs flag: stdout is the header lines and one JSON row a step,
    exactly the rows it returns, as before the sink existed; --obs-sink
    stdout adds only ``# obs[...]`` lines."""
    from repro_torch.launch import train
    argv = ["--arch", "dcgan32", "--smoke", "--device", "cpu", "--steps",
            "2", "--compressor", "qsgd8_block1024", "--comm-plan", "uniform"]
    rows = train.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in lines if not x.startswith("#")] == rows
    assert [json.dumps(r) for r in rows] == [x for x in lines
                                             if not x.startswith("#")]
    assert [x.split(":")[0] for x in lines if x.startswith("#")] == [
        "# comm", "# comm", "# strategy", "# device"]
    train.main(argv + ["--obs-sink", "stdout"])
    verbose = capsys.readouterr().out.splitlines()
    extra = [x for x in verbose if x.startswith("# obs[")]
    assert len(verbose) - len(extra) == len(lines)
    assert {x.split("]")[0] for x in extra} == {
        "# obs[run_meta", "# obs[timing", "# obs[comm_summary"}
