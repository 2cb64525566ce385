"""Port parity: the W = 4 DQGAN step of `repro_torch` (workers stacked on
one device, and spread over 4 gloo ranks, one a rank) against
`repro.core.dqgan.DQGAN.step` on 4 forced host devices (`shard_map` over
a `data` mesh axis), 3 steps of the mixture MLP GAN (6 under the
`delayed` schedule with the per-worker τ-vector (1, 2, 3, 4), half the
workers reporting, the adaptive PlanFamily: each worker's message reaches
the wire τ_m steps after it was made).

One subprocess runs every configuration on the JAX side and writes, per
configuration, the initial parameters, each step's batch and draws and the
final state to an `.npz`; the port replays them stacked in this process
and across 4 ranks (`torch_ranks.run_ranks`, spawned once). The JAX
step's output state is held to its input's shardings, so the steps of a
configuration share one compilation. The draws are computed outside the `shard_map`
the way the JAX step derives them: worker key `fold_in(key, w)`, then
`split(fold_in(·, step))` into the field's key and the quantizer's `kq`;
bucket draws from `fold_in(kq, 100_000 + bid)` (two_phase: `split(·, W+1)`,
phase 1 from the first W keys, phase 2 from the last), leaf draws from
`fold_in(kq, leaf index)`, the participation mask from the shared key. The
port replays them on the CPU.

What is compared, and how tightly:
  * the quantization-invariant part of the state. EF keeps p̂ + e' = m
    for a participant, and a worker sitting a round out adds its whole
    message to e1, so w − (1/n)·Σ_w e1_w (and, for two_phase, minus
    (W/n)·e2, the owners' residual, unchunked), n the participants of a
    round, moves by −(1/n)·Σ_w p_w each round whatever the codes did:
    it agrees to float32 rounding of the two frameworks' fields and of
    the order of the workers' sums (1e-6 of the largest parameter, plus
    float32 rounding of m: 1e-6·127·max|e|);
  * the parameters: that, plus one quantization step, for a code flipped
    at a rounding boundary by a last-bit difference of m;
  * the fraction of residual elements that differ by more than rounding
    (a flipped code): at most 1e-3 (expected none);
  * loss and grad_norm, the means over workers: rtol 1e-5;
  * under `delayed`, the version vector exactly;
  * where the step's telemetry is on (OBS_FULL), every step's
    metrics["obs"] by the rule of tests/test_torch_obs.py.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import gan as TG
from repro_torch.parity import agreement
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import run_cases, run_ranks
from torch_ranks import one_thread  # noqa: F401 (autouse)

W, B, STEPS = 4, 64, 3
TCFG = TG.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                    hidden=128)
FULL = dict(compressor="qsgd8_block1024", plan="uniform", bucket_mb=0.03)
ADAPTIVE = dict(compressor="qsgd8_block1024", plan="delta_budget",
                budget_mb=0.033, bucket_mb=0.03, adaptive=True)
# name: (compression, exchange kind, participation fraction)
CONFIGS = {
    f"{kind}_{label}": (comp, kind, frac)
    for kind in ("sim", "allgather", "two_phase")
    for label, comp, frac in (("full", FULL, 1.0),
                              ("adaptive", ADAPTIVE, 0.5))
}
CONFIGS["sim_per_leaf_partial"] = (dict(compressor="qsgd8_linf"), "sim", 0.5)
# the delayed schedule, a per-worker τ-vector, half reporting, adaptive
TAU_VECTOR = (1, 2, 3, 4)
CONFIGS["sim_adaptive_tau_vector"] = (ADAPTIVE, "sim", 0.5,
                                      dict(kind="delayed", tau=4,
                                           tau_vector=TAU_VECTOR))
# steps of a configuration (STEPS unless listed)
CONFIG_STEPS = {"sim_adaptive_tau_vector": 6}
# configurations run with the step's telemetry on (metrics full), on both
# sides; it changes no state
OBS_FULL = ("sim_adaptive", "sim_adaptive_tau_vector")

SCRIPT = r"""
import json, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.parallel.compat import make_mesh, set_mesh
from repro.configs.base import DQConfig
from repro.core import compressors as C
from repro.core import error_feedback as EF
from repro.core.dqgan import DQGAN
from repro.models.gan import GANConfig, mlp_gan_init, gan_field_fn
from repro.strategy import Strategy

W, B = %(W)d, %(B)d
CONFIGS = json.loads(%(configs)r)
STEPS = json.loads(%(steps)r)
mesh = make_mesh((W,), ("data",))
cfg = GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                hidden=128)
params = mlp_gan_init(jax.random.key(0), cfg)
KEY = jax.random.key(7)
out = {}


def put(name, x):
    if isinstance(x, dict):
        for k, v in x.items():
            put(f"{name}/{k}", v)
        return
    out[name] = np.asarray(jax.device_get(x))


def blocked(comp, d):
    b = comp.per_block
    return (1, d) if b <= 0 else (-(-d // b), b)


def draw(comp, key, d):
    if EF.fused_compatible(comp, jax.ShapeDtypeStruct((d,), jnp.float32)):
        return jax.random.uniform(key, (d,))
    return jax.random.uniform(key, blocked(comp, d))


def record_draws(tr, name, step):
    pre = f"{name}/draws/{step}"
    kqs, zs = [], []
    for w in range(W):
        kf, kq = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(KEY, w), step))
        zs.append(jax.random.normal(kf, (B // W, cfg.latent_dim)))
        kqs.append(kq)
    put(f"{pre}/z", jnp.stack(zs))
    part = tr.strategy.participation.round_setup(
        KEY, step, W, tr.strategy.schedule.period)
    if part is not None:
        put(f"{pre}/mask", part[0])
    kind = tr.strategy.exchange.kind
    if tr.bucketed:
        layout, cplan = tr._comm(params)
        streams = [(b.bid, C.get(a.compressor), b.size, 100_000 + b.bid)
                   for b, a in zip(layout.buckets, cplan.assignments)]
    else:
        streams = [(i, tr.compressor, int(np.prod(l.shape)), i)
                   for i, l in enumerate(jax.tree.leaves(params))]
    for sid, comp, d, fold in streams:
        keys = [jax.random.fold_in(k, fold) for k in kqs]
        if kind == "two_phase":
            # buckets always chunk (padded to a multiple of W·1024)
            ks = [jax.random.split(k, W + 1) for k in keys]
            c = d // W
            put(f"{pre}/rand/{sid}/phase1", jnp.stack([jnp.stack(
                [jax.random.uniform(k[j], blocked(comp, c))
                 for j in range(W)]) for k in ks]))
            put(f"{pre}/rand/{sid}/phase2",
                jnp.stack([draw(comp, k[W], c) for k in ks]))
        else:
            put(f"{pre}/rand/{sid}",
                jnp.stack([draw(comp, k, d)
                           for k in keys]).reshape((W, -1)))


for name, sjson in CONFIGS.items():
    strat = Strategy.from_json(sjson)
    tr = DQGAN(field_fn=gan_field_fn(cfg),
               dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-2,
                                         message="update"),
               mesh=mesh, batch_spec=P(("data",)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with set_mesh(mesh):
            st = tr.init(params)
            # the output state keeps the input's shardings: one compile
            # serves every step
            shardings = jax.tree.map(
                lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
                else NamedSharding(mesh, P()), st)
            st = jax.device_put(st, shardings)

            def pinned(st, batch, key):
                res = tr.step(st, batch, key)
                return res._replace(state=jax.lax.with_sharding_constraint(
                    res.state, shardings))

            step = jax.jit(pinned)
            for t in range(STEPS[name]):
                real = jax.random.normal(jax.random.fold_in(
                    jax.random.key(1), t), (B, 2))
                put(f"{name}/batch/{t}", real)
                record_draws(tr, name, t)
                res = step(st, {"real": real}, KEY)
                st = res.state
                for k, v in res.metrics.items():
                    put(f"{name}/metrics/{t}/{k}", v)
    st = jax.device_get(st)
    for i, x in enumerate(jax.tree.leaves(st.params)):
        put(f"{name}/params/{i}", x)
    if st.sched is not None and "versions" in st.sched:
        put(f"{name}/versions", st.sched["versions"])
    leaf_ef = st.ef["leaf"] if tr.bucketed else st.ef
    for i, e in enumerate(jax.tree.leaves(
            leaf_ef, is_leaf=lambda x: isinstance(x, dict) and "e1" in x)):
        for k, v in e.items():
            put(f"{name}/ef/leaf/{i}/{k}", v)
    if tr.bucketed:
        for bid, e in st.ef["bucket"].items():
            put(f"{name}/ef/bucket/{bid}/e2", e["e2"])
        fam = tr._family(params)
        if fam is not None:
            print(name, fam.describe())
for i, x in enumerate(jax.tree.leaves(params)):
    put(f"init/{i}", x)
np.savez(%(path)r, **out)
print("OK")
"""


def _steps(name):
    return CONFIG_STEPS.get(name, STEPS)


def _jax_strategy_json(comp, kind, frac, schedule=None, metrics="off"):
    from repro.strategy import Compression, ExchangePlan, Observability
    from repro.strategy import Participation, Schedule, Strategy
    return Strategy(compression=Compression(**comp),
                    exchange=ExchangePlan(kind=kind, worker_axes=("data",)),
                    schedule=Schedule(**(schedule or {})),
                    participation=Participation(fraction=frac),
                    observability=Observability(metrics=metrics)).to_json()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    from conftest import run_multidevice
    path = str(tmp_path_factory.mktemp("mw") / "runs.npz")
    import json
    configs = {n: _jax_strategy_json(
        *c, metrics="full" if n in OBS_FULL else "off")
        for n, c in CONFIGS.items()}
    steps = {n: _steps(n) for n in CONFIGS}
    out = run_multidevice(SCRIPT % dict(W=W, B=B, path=path,
                                        configs=json.dumps(configs),
                                        steps=json.dumps(steps)),
                          n_devices=W)
    assert "OK" in out
    data = dict(np.load(path))
    os.remove(path)
    return configs, data, out


def _t(x):
    return torch.from_numpy(np.array(x))


def _replay(data, name, t):
    pre = f"{name}/draws/{t}/"
    draws = {"z": _t(data[pre + "z"]), "rand": {}}
    if pre + "mask" in data:
        draws["mask"] = _t(data[pre + "mask"])
    for k in data:
        if k.startswith(pre + "rand/"):
            parts = k[len(pre + "rand/"):].split("/")
            sid = int(parts[0])
            if len(parts) == 1:
                draws["rand"][sid] = _t(data[k])
            else:
                draws["rand"].setdefault(sid, {})[parts[1]] = _t(data[k])
    return draws


def _run_port(configs, data, name):
    tstrat = TStrategy.from_json(configs[name])
    tr = TDQGAN(field_fn=TG.gan_field_fn(TCFG),
                dq=TDQ.from_strategy(tstrat, optimizer="omd", lr=1e-2,
                                     message="update"),
                device="cpu", workers=W)
    paths, shapes = T.flatten(TG.init(TCFG, device="meta"))
    params = T.unflatten(paths, [_t(data[f"init/{i}"])
                                 for i in range(len(paths))])
    st = tr.init(params)
    n = W
    for t in range(_steps(name)):
        draws = _replay(data, name, t)
        if "mask" in draws:
            n = int(draws["mask"].sum())
        out = tr.step(st, {"real": _t(data[f"{name}/batch/{t}"])}, draws)
        st = out.state
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                float(out.metrics[k]), float(data[f"{name}/metrics/{t}/{k}"]),
                rtol=1e-5, atol=1e-7)
    return tr, st, paths, n


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CONFIGS))
def test_four_worker_trajectory_matches(jax_runs, name):
    configs, data, _ = jax_runs
    tr, st, paths, n = _run_port(configs, data, name)
    leaf_ef = st.ef["leaf"] if tr.bucketed else st.ef
    e2 = None
    if tr.bucketed and tr.strategy.exchange.owner_ef:
        e2 = {int(b): e["e2"].numpy() for b, e in st.ef["bucket"].items()}
    _assert_matches_jax(
        data, name, tr, n, [x.numpy() for x in T.flatten_up_to(paths,
                                                                st.params)],
        [x["e1"].numpy() for x in T.flatten_up_to(paths, leaf_ef)], e2,
        st.sched["versions"].numpy() if st.sched and "versions" in st.sched
        else None)


def _assert_matches_jax(data, name, tr, n, tp, te, te2_by_bid, versions):
    """The port's final params, e1 leaves, e2 buckets and versions against
    the JAX run's, by the rule of the module's docstring
    (`repro_torch.parity`)."""
    n_leaves = len(tp)
    jp = [data[f"{name}/params/{i}"] for i in range(n_leaves)]
    je = [data[f"{name}/ef/leaf/{i}/e1"] for i in range(n_leaves)]
    e2, layout = None, None
    if te2_by_bid is not None:
        layout, _ = tr._comm(T.unflatten(T.flatten(TG.init(
            TCFG, device="meta"))[0], [torch.from_numpy(x) for x in tp]))
        e2 = ([data[f"{name}/ef/bucket/{b.bid}/e2"] for b in layout.buckets],
              [te2_by_bid[b.bid] for b in layout.buckets])
    jv = data[f"{name}/versions"] if f"{name}/versions" in data else None
    problems = agreement(
        (jp, tp), (je, te), W, n, e2=e2, layout=layout,
        versions=None if jv is None else (jv, versions)).problems
    assert not problems, problems


def _rank_case(configs, data, name):
    """`name`'s JAX run as a `torch_ranks` case: its initial parameters,
    batches and draws (numpy, the global (W, ...) layout)."""
    paths, _ = T.flatten(TG.init(TCFG, device="meta"))
    draws = []
    for t in range(_steps(name)):
        d = _replay(data, name, t)
        draws.append({k: ({s: ({p: x.numpy() for p, x in r.items()}
                               if isinstance(r, dict) else r.numpy())
                           for s, r in v.items()} if k == "rand"
                          else v.numpy()) for k, v in d.items()})
    return dict(strategy=configs[name], W=W, paths=paths,
                params=[np.array(data[f"init/{i}"])
                        for i in range(len(paths))],
                batches=[np.array(data[f"{name}/batch/{t}"])
                         for t in range(_steps(name))], draws=draws,
                lr=1e-2)


@pytest.fixture(scope="module")
def four_ranks(jax_runs):
    """Every configuration replayed over 4 gloo ranks, one worker a rank
    (spawned once): rank 0's gathered results."""
    configs, data, _ = jax_runs
    cases = [_rank_case(configs, data, name) for name in CONFIGS]
    return dict(zip(CONFIGS, run_ranks(run_cases, W, cases,
                                       timeout=240)[0]))


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CONFIGS))
def test_four_ranks_trajectory_matches(jax_runs, four_ranks, name):
    """The slice against JAX: the same replay through ProcessGroupWorkers
    (all_reduce, all_gather, all_to_all over gloo)."""
    configs, data, _ = jax_runs
    res = four_ranks[name]
    for t, m in enumerate(res["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                m[k], float(data[f"{name}/metrics/{t}/{k}"]), rtol=1e-5,
                atol=1e-7)
    st = res["state"]
    tr = TDQGAN(field_fn=TG.gan_field_fn(TCFG),
                dq=TDQ.from_strategy(TStrategy.from_json(configs[name]),
                                     optimizer="omd", lr=1e-2),
                device="cpu", workers=W)
    n = W
    for t in range(_steps(name)):
        mask = data.get(f"{name}/draws/{t}/mask")
        if mask is not None:
            n = int(mask.sum())
    e2 = {int(k.split("/")[2]): v for k, v in st.items()
          if k.startswith("ef/bucket/")} or None
    _assert_matches_jax(
        data, name, tr, n, [v for k, v in st.items()
                            if k.startswith("params/")],
        [v for k, v in st.items() if k.startswith("ef/") and
         k.endswith("/e1")], e2, st.get("sched/versions"))


@pytest.mark.multidevice
def test_adaptive_runs_select_a_family_member_on_the_device(jax_runs):
    """Two of four workers report: the selected row differs from the full
    plan, and the port builds the same family as the JAX package."""
    configs, _, out = jax_runs
    tstrat = TStrategy.from_json(configs["sim_adaptive"])
    tr = TDQGAN(field_fn=TG.gan_field_fn(TCFG),
                dq=TDQ.from_strategy(tstrat, optimizer="omd", lr=1e-2),
                device="cpu", workers=W)
    params = TG.init(TCFG)
    fam = tr._family(params)
    assert f"sim_adaptive {fam.describe()}" in out
    table = fam.levels_table()
    assert fam.n_distinct > 1 and table[1] != table[-1]
    assert tr._comm_full(params)[3].tolist() == [list(r) for r in table]


@pytest.mark.multidevice
@pytest.mark.parametrize("name", OBS_FULL)
def test_four_worker_obs_matches_jax(jax_runs, name, monkeypatch):
    """Four workers stacked, half reporting, the adaptive family (B2's
    plain version), every step's metrics["obs"] against the JAX run on 4
    devices, by tests/test_torch_obs.py's rule; under the τ-vector the
    staleness histogram counts each worker's own staleness."""
    from repro_torch.core import compressors as TC
    from test_torch_obs import _assert_obs_close, _delta_bound, _Spy
    configs, data, _ = jax_runs
    tr = TDQGAN(field_fn=TG.gan_field_fn(TCFG), device="cpu", workers=W,
                dq=TDQ.from_strategy(TStrategy.from_json(configs[name]),
                                     optimizer="omd", lr=1e-2,
                                     message="update"))
    assert tr.strategy.observability.metrics == "full"
    paths, _ = T.flatten(TG.init(TCFG, device="meta"))
    st = tr.init(T.unflatten(paths, [_t(data[f"init/{i}"])
                                     for i in range(len(paths))]))
    family = tr._family(st.params)
    block = family.base_compressor and TC.get(
        family.base_compressor).per_block
    spy = _Spy(monkeypatch)
    worst = 0.0
    for t in range(_steps(name)):
        out = tr.step(st, {"real": _t(data[f"{name}/batch/{t}"])},
                      _replay(data, name, t))
        st = out.state
        pre = f"{name}/metrics/{t}/obs/"
        jo = {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
        n = int(data[f"{name}/draws/{t}/mask"].sum())
        row = family.levels_table()[n - 1]
        bound = _delta_bound(spy.step(), dict(enumerate(row)), block)
        worst = max(worst, _assert_obs_close(jo, out.metrics["obs"], bound,
                                             f"{name} step {t}"))
        if "tau" in name:
            assert float(out.metrics["obs"]["staleness_hist"].sum()) == W
    assert worst <= 1e-6, worst


@pytest.mark.parametrize("strategy", ["exact", "sim", "allgather",
                                      "two_phase"])
def test_lossless_exchange_is_the_workers_mean(strategy):
    """With the identity compressor every strategy's q̂ is the mean over
    the stacked workers (`StackedWorkers`' mean, all_gather and
    all_to_all), to float32 rounding of the order of the sums, and the
    workers' residuals stay zero."""
    from repro_torch.core import compressors as TC
    from repro_torch.core import exchange as TX
    p = torch.from_numpy(
        np.random.RandomState(0).randn(W, 8, 6).astype(np.float32))
    plan = TX.plan_leaf(strategy, (8, 6), None, W)
    ef = {"e1": torch.zeros_like(p)}
    if TX.plan_has_owner_ef(plan):
        ef["e2"] = torch.zeros((W, 8 // W, 6))
    q, ne = TX.exchange_leaf(TC.get("identity"), plan, p, ef, None,
                             TX.StackedWorkers(W), True)
    assert q.shape == (8, 6)
    np.testing.assert_allclose(q.numpy(), p.mean(0).numpy(), rtol=0,
                               atol=1e-6)
    assert not ne["e1"].any()


def test_participation_counts_and_masks_match():
    """Count-exact participation: the same n per round as the JAX package,
    the same host-side sample from the same numpy state, and a device mask
    with exactly n ones whose sum selects the PlanFamily row."""
    from repro.sched import participation as JP
    from repro_torch.sched import participation as TP
    for M in (1, 2, 4, 8):
        for p in (0.1, 0.25, 0.5, 0.75, 1.0):
            n = TP.n_participants(p, M)
            assert n == JP.n_participants(p, M)
            np.testing.assert_array_equal(
                TP.host_round_participants(np.random.RandomState(M), M, n),
                JP.host_round_participants(np.random.RandomState(M), M, n))
            mask = TP.round_mask(torch.Generator().manual_seed(M), M, n)
            assert mask.dtype == torch.float32 and set(mask.tolist()) <= {0, 1}
            assert int(TP.round_count(mask)) == n
    with pytest.raises(ValueError):
        TP.n_participants(0.0, 4)
