"""The port's `torch.distributed` worker backend on the CPU (gloo): DQGAN's
W = 4 workers spread over 2 ranks × 2 and 4 ranks × 1
(`core.exchange.ProcessGroupWorkers`, `launch.mesh.ProcessMesh`), held
against the same W = 4 stacked on one device (`StackedWorkers`), on the
mixture MLP GAN, 3 steps (6 under the delayed τ-vector (1, 2, 3, 4)).

Each world size is spawned once for the module (`torch_ranks.run_ranks`,
one thread a rank, every wait bounded); its ranks run every case.

What is compared, and how tightly (the tolerances the port holds itself
to against the JAX package, tests/test_torch_multiworker.py's docstring:
`all_reduce` sums in another order than `x.mean(0)`):
  * params − (1/n)·Σ_w e1_w (− (W/n)·e2, two_phase) to float32 rounding,
    params within one quantization step, at most 1e-3 of the residual
    elements flipped, loss and grad_norm to rtol 1e-5;
  * bit for bit where no float sum crosses ranks: the state after step 0
    but the parameters (e1, e2, the schedule's slots, versions: the codes
    sent are m − e1), the versions at the end, and the participation
    masks, which every rank draws from the shared stream;
  * with injected draws and without: worker m draws from a generator
    seeded from (seed, step, m), whatever the split (draw invariance).

fsdp (zero-3 through two_phase and a block-1024 moment compressor, zero-2
under oadam, and exact zero-3) over 2 and 4 ranks against stacked: the
compressed runs bit for bit (no float sum crosses ranks: the all_to_all
moves codes, each owner averages its chunk in the stacked order, every
worker decompresses the same gathered payload), the exact run to float32
rounding of the reduce-scatter's sum (atol 1e-6 of the largest
parameter); and the reduce-scatter collective against the stacked one.

Also here: the two_phase phase-1 compress over the stacked chunk rows is
the per-chunk loop bit for bit; ports of the JAX package's
tests/test_distributed.py to 4 ranks; checkpoints saved across ranks
(the stacked save's files member for member, restored by the JAX
package, resumed bit for bit); the training CLI under torchrun.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as TCK
from repro_torch import tree as T
from repro_torch.core import compressors as TC
from repro_torch.core import error_feedback as TEF
from repro_torch.core import exchange as TX
from repro_torch.strategy import Compression, ExchangePlan, Strategy
from torch_ranks import (MIXTURE_CONFIGS, assert_states_agree, fsdp_strategy,
                         make_trainer, mixture_case, mixture_params, run_case,
                         run_cases, run_ranks, strategy_case)
from torch_ranks import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
CONFIGS = {n: c for n, c in MIXTURE_CONFIGS.items() if n != "two_phase_delayed2"}
WORLDS = (2, 4)


CASES = [(name, inject) for name in CONFIGS for inject in (True, False)]
# fsdp cases: name -> (fsdp_strategy keywords, optimizer)
FSDP_CASES = {
    "zero3_two_phase": (dict(zero_stage=3), "omd"),
    "zero2_two_phase_oadam": (dict(zero_stage=2), "oadam"),
    "zero3_exact": (dict(zero_stage=3, kind="exact", moments="identity"),
                    "omd"),
}


def _fsdp_case(name):
    kw, opt = FSDP_CASES[name]
    return strategy_case(fsdp_strategy(**kw), optimizer=opt)


def _collectives(mesh, seed):
    """This rank's results of the three collectives, and their start
    forms finished out of order, on rows of a global tensor."""
    wk = TX.ProcessGroupWorkers(mesh, W)
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(W, 6, 5).astype(np.float32))
    y = torch.from_numpy(rs.randn(W, W, 3, 2).astype(np.float32))
    c = torch.from_numpy(rs.randint(-127, 128, (W, 7)).astype(np.int8))
    z = torch.from_numpy(rs.randn(W, 8 * W).astype(np.float32))
    hm, hg, ha, hr = (wk.start_mean(wk.rows(x)),
                      wk.start_all_gather(wk.rows(c)),
                      wk.start_all_to_all(wk.rows(y)),
                      wk.start_reduce_scatter(wk.rows(z)))
    return {"all_to_all": ha.wait().numpy(), "all_gather": hg.wait().numpy(),
            "reduce_scatter": hr.wait().numpy(),
            "mean": hm.wait().numpy(), "offset": wk.offset,
            "n_local": wk.n_local,
            "max": float(wk.max(wk.rows(x)[:, 0, 0])),
            "mean_each": [float(v) for v in wk.mean_each(
                [wk.rows(x)[:, 0, 0], wk.rows(x)[:, 1, 1]])]}


def _ranks_main(mesh, cases, ckpt_dir, extra):
    out = {"cases": run_cases(mesh, cases), "coll": _collectives(mesh, 5)}
    if ckpt_dir is not None:
        out["ckpt"] = _checkpoints(mesh, ckpt_dir)
    for name, args in extra:
        out[name] = EXTRA[name](mesh, *args)
    return out


@pytest.fixture(scope="module")
def stacked():
    return {c: run_case(mixture_case(*c)) for c in CASES}


@pytest.fixture(scope="module")
def fsdp_stacked():
    return {n: run_case(_fsdp_case(n)) for n in FSDP_CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [each rank's results]}, one spawn a world size (the fsdp
    cases after the mixture cases)."""
    cases = ([mixture_case(*c) for c in CASES]
             + [_fsdp_case(n) for n in FSDP_CASES])
    out = {}
    for world in WORLDS:
        ckpt = (str(tmp_path_factory.mktemp("ckpt")) if world == 2
                else None)
        extra = ([("delta1", ()), ("semantics", ())] if world == 4 else [])
        out[world] = run_ranks(_ranks_main, world, cases, ckpt, extra,
                               timeout=240)
    out["ckpt_dir"] = out[2][0]["ckpt"]["dir"]
    return out


def _n_part(name):
    if name in FSDP_CASES:      # fsdp runs every worker every round
        return W
    frac = CONFIGS[name][2]
    return max(1, round(frac * W))


def _layout(name):
    _, _, params = mixture_params()
    return make_trainer(_ckpt_case(name))._comm(params)[0]


@pytest.mark.parametrize("name,inject", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_backend_matches_stacked(stacked, ranks, world, name, inject):
    ref, got = stacked[name, inject], ranks[world][0]["cases"][
        CASES.index((name, inject))]
    assert_states_agree(ref["state"], got["state"], W, _n_part(name),
                        _layout(name), label=f"{world} ranks {name}")
    for a, b in zip(ref["metrics"], got["metrics"]):
        for k in ("loss", "grad_norm", "error_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7)
        assert b["staleness_max"] == a["staleness_max"]
        np.testing.assert_allclose(b["staleness_mean"], a["staleness_mean"],
                                   rtol=1e-6)


@pytest.mark.parametrize("name,inject", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_bit_equal_where_no_sum_crosses_ranks(stacked, ranks, world, name,
                                              inject):
    """After step 0 every per-worker row (the residuals e1 = m − p̂ and so
    the codes sent, e2, the schedule's slots and versions) is bit-equal to
    the stacked run's; every rank draws the stacked run's masks."""
    ref = stacked[name, inject]
    got = ranks[world][0]["cases"][CASES.index((name, inject))]
    s0, g0 = ref["state0"], got["state0"]
    assert list(s0) == list(g0)
    for k in s0:
        if k.split("/")[0] in TCK.PER_WORKER_FIELDS:
            np.testing.assert_array_equal(g0[k], s0[k], err_msg=k)
    for r in ranks[world]:
        masks = r["cases"][CASES.index((name, inject))]["masks"]
        for a, b in zip(ref["masks"], masks):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(FSDP_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_ranks_match_stacked(fsdp_stacked, ranks, world, name):
    ref = fsdp_stacked[name]
    got = ranks[world][0]["cases"][len(CASES) + list(FSDP_CASES).index(name)]
    a, b = ref["state"], got["state"]
    assert list(a) == list(b) and any(k.startswith("fsdp/") for k in a)
    scale = max(np.abs(v).max() for k, v in a.items()
                if k.startswith("params/"))
    for k in a:
        if "exact" in name:
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=1e-6 * scale, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for ma, mb in zip(ref["metrics"], got["metrics"]):
        for k in ("loss", "grad_norm", "error_norm"):
            np.testing.assert_allclose(mb[k], ma[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_match_the_stacked_backend(ranks, world):
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(W, 6, 5).astype(np.float32))
    y = torch.from_numpy(rs.randn(W, W, 3, 2).astype(np.float32))
    c = torch.from_numpy(rs.randint(-127, 128, (W, 7)).astype(np.int8))
    z = torch.from_numpy(rs.randn(W, 8 * W).astype(np.float32))
    st = TX.StackedWorkers(W)
    assert st.n == st.n_local == W and st.offset == 0
    for r, res in enumerate(r["coll"] for r in ranks[world]):
        rows = slice(res["offset"], res["offset"] + res["n_local"])
        assert res["n_local"] == W // world and res["offset"] == r * W // world
        np.testing.assert_array_equal(res["all_gather"],
                                      st.all_gather(c).numpy())
        np.testing.assert_array_equal(res["all_to_all"],
                                      st.all_to_all(y).numpy()[rows])
        np.testing.assert_allclose(res["mean"], st.mean(x).numpy(),
                                   rtol=0, atol=1e-6)
        # row w: the mean over the workers of chunk w
        want = z.reshape(W, W, 8).mean(dim=0).numpy()
        np.testing.assert_allclose(res["reduce_scatter"], want[rows],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(st.reduce_scatter(z).numpy(), want,
                                   rtol=0, atol=1e-6)
        assert res["max"] == float(st.max(x[:, 0, 0]))
        np.testing.assert_allclose(
            res["mean_each"], [float(v) for v in st.mean_each(
                [x[:, 0, 0], x[:, 1, 1]])], rtol=1e-6)


# --------------------------------------------------------------------------- #
# two_phase phase 1: one stacked compress, the per-chunk loop bit for bit
# --------------------------------------------------------------------------- #
def _phase1_loop(compressor, m, rand):
    """The per-chunk loop phase 1 ran before (codes, dequantized chunks)."""
    pls = [compressor.compress(m[i], None if rand is None else rand[i])
           for i in range(m.shape[0])]
    x_hat = torch.stack([compressor.decompress(pl, m.shape[1:], m.dtype)
                         for pl in pls])
    return {k: torch.stack([p[k] for p in pls]) for k in pls[0]}, x_hat


@pytest.mark.parametrize("comp", ["qsgd8_block1024", "qsgd4_block1024",
                                  "qsgd8_linf", "qsgd8_l2", "traced",
                                  "identity", "topk10"])
@pytest.mark.parametrize("use_ef", [True, False])
def test_phase1_stacked_compress_is_the_chunk_loop(comp, use_ef):
    rs = np.random.RandomState(0)
    L_, n = 2, 2048
    compressor = (TC.TracedQuant(torch.tensor([31.0]), per_block=1024)
                  if comp == "traced" else TC.get(comp))
    p = torch.from_numpy(rs.randn(L_ * W, n).astype(np.float32))
    e = torch.from_numpy(0.01 * rs.randn(L_ * W, n).astype(np.float32))
    r = torch.from_numpy(rs.rand(L_ * W, n).astype(np.float32))
    payload, m_hat, e_new = TEF.compress_with_ef_stacked(
        compressor, p, e, r, None, use_ef=use_ef, allow_fused=False)
    m = p + e if use_ef else p
    ref_pl, ref_hat = _phase1_loop(compressor, m, r)
    assert sorted(payload) == sorted(ref_pl)
    for k in ref_pl:
        assert torch.equal(payload[k].reshape(ref_pl[k].shape), ref_pl[k]), k
    assert torch.equal(m_hat, ref_hat)
    assert torch.equal(e_new, m - ref_hat if use_ef else e)
    back = TEF.decompress_rows(compressor, payload, (n,), torch.float32)
    assert torch.equal(back, ref_hat)


def test_two_phase_exchange_equals_the_old_chunk_loop():
    """The whole two_phase exchange of one (W, n) bucket against the old
    code path (phase 1 a chunk at a time), with the same draws."""
    rs = np.random.RandomState(1)
    n = W * 2048
    comp = TC.get("qsgd8_block1024")
    p = torch.from_numpy(rs.randn(W, n).astype(np.float32))
    ef = {"e1": torch.from_numpy(0.01 * rs.randn(W, n).astype(np.float32)),
          "e2": torch.from_numpy(0.01 * rs.randn(W, n // W).astype(
              np.float32))}
    rand = {"phase1": torch.from_numpy(rs.rand(W, W, n // W).astype(
        np.float32)), "phase2": torch.from_numpy(rs.rand(W, n // W).astype(
            np.float32))}
    plan = TX.plan_bucket("two_phase", n, W)
    q, ne = TX.exchange_leaf(comp, plan, p, ef, rand, TX.StackedWorkers(W),
                             True)
    m = (p + ef["e1"]).reshape(W, W, n // W)
    pl, x_hat = _phase1_loop(comp, m.reshape(W * W, -1),
                             rand["phase1"].reshape(W * W, -1))
    np.testing.assert_array_equal(
        ne["e1"].numpy(), (m.reshape(W * W, -1) - x_hat).reshape(W, n))
    contrib = x_hat.reshape(W, W, -1).transpose(0, 1)   # (dst, src, chunk)
    chunk_mean = contrib.mean(dim=1)
    _, c_hat, e2 = TEF.compress_with_ef_stacked(comp, chunk_mean, ef["e2"],
                                                rand["phase2"])
    np.testing.assert_array_equal(ne["e2"].numpy(), e2.numpy())
    np.testing.assert_array_equal(q.numpy(), c_hat.reshape(n).numpy())


# --------------------------------------------------------------------------- #
# ports of the JAX package's tests/test_distributed.py, on 4 ranks
# --------------------------------------------------------------------------- #
def _bilinear_run(mesh, kind, compressor, steps=25):
    strat = Strategy(compression=Compression(compressor=compressor),
                     exchange=ExchangePlan(kind=kind, worker_axes=("data",)))
    case = dict(strategy=strat.to_json(), W=W, field="bilinear_distributed",
                paths=[("x",), ("y",)], params=[np.ones(4, np.float32)] * 2,
                batches=[np.zeros((8, 1), np.float32)] * steps, lr=0.05)
    st = run_case(case, mesh)
    return st.get("state")


def _delta1(mesh):
    return {f"{k}/{c}": _bilinear_run(mesh, k, c) for k, c in (
        ("exact", "identity"), ("sim", "identity"), ("sim", "qsgd8_linf"),
        ("allgather", "qsgd8_linf"), ("two_phase", "qsgd8_linf"))}


def _semantics(mesh):
    """JAX's test_exchange_semantics with W = 8 workers over the 4 ranks
    (2 a rank): the allgather q̂ is the mean of each worker's round trip
    with its own draws, every rank gets the same q̂; two_phase with the
    identity compressor is the exact mean."""
    W8, shape = 8, (16, 32)
    wk = TX.ProcessGroupWorkers(mesh, W8)
    ps = torch.from_numpy(np.random.RandomState(0).randn(
        W8, *shape).astype(np.float32))
    comp = TC.get("qsgd8_linf")
    gens = [torch.Generator().manual_seed(100 + wk.offset + i)
            for i in range(wk.n_local)]
    plan = TX.plan_leaf("allgather", shape, None, W8)
    mine = wk.rows(ps)
    q, _ = TX.exchange_leaf(comp, plan, mine, {"e1": torch.zeros_like(mine)},
                            None, wk, True, gens)
    plan2 = TX.plan_leaf("two_phase", shape, None, W8)
    st = TX.ef_state_zeros(plan2, shape, torch.float32, W8, True)
    st = {k: torch.zeros((wk.n_local,) + tuple(v.shape)) for k, v in
          st.items()}
    q2, _ = TX.exchange_leaf(TC.get("identity"), plan2, mine, st, None, wk,
                             True)
    return {"q": q.numpy(), "q2": q2.numpy(), "plan2": plan2}


EXTRA = {"delta1": _delta1, "semantics": _semantics}


def test_delta1_equivalence_and_strategies(ranks):
    res = ranks[4][0]["delta1"]
    exact, sim_id = res["exact/identity"], res["sim/identity"]
    for k in ("params/x", "params/y"):       # δ = 1: bit-exact
        np.testing.assert_array_equal(exact[k], sim_id[k])
    for kind in ("sim", "allgather", "two_phase"):
        q = res[f"{kind}/qsgd8_linf"]
        d = float(np.linalg.norm(q["params/x"] - exact["params/x"])
                  + np.linalg.norm(q["params/y"] - exact["params/y"]))
        assert d < 0.5, (kind, d)


def test_exchange_semantics(ranks):
    W8, shape = 8, (16, 32)
    ps = torch.from_numpy(np.random.RandomState(0).randn(
        W8, *shape).astype(np.float32))
    comp = TC.get("qsgd8_linf")
    ref = torch.stack([comp.decompress(
        comp.compress(ps[w], None, torch.Generator().manual_seed(100 + w)),
        shape, torch.float32) for w in range(W8)]).mean(0)
    outs = [r["semantics"] for r in ranks[4]]
    assert outs[0]["plan2"]["strategy"] == "two_phase"
    assert outs[0]["plan2"]["chunk_axis"] == 1
    np.testing.assert_allclose(outs[0]["q"], ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    for o in outs[1:]:     # every rank received the same q̂
        np.testing.assert_array_equal(o["q"], outs[0]["q"])
    for o in outs:
        np.testing.assert_allclose(o["q2"], ps.mean(0).numpy(), rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------- #
# checkpoints across ranks
# --------------------------------------------------------------------------- #
CKPT_CONFIGS = ("two_phase_adaptive", "sim_adaptive_tau_vector",
                "zero3_two_phase")


def _ckpt_case(name, steps=None):
    """A checkpoint config's case: a mixture config, or an fsdp case
    (whose shard slots gather to rank 0 like every per-worker field)."""
    if name in FSDP_CASES:
        kw, opt = FSDP_CASES[name]
        return strategy_case(fsdp_strategy(**kw), steps=steps or 3,
                             optimizer=opt)
    return mixture_case(name, False, steps=steps)
CKPT_FORMATS = ("npz", "sharded")


def _save(fmt, path, st, strat, workers, n_shards=None):
    meta = {"strategy": strat}
    if fmt == "npz":
        TCK.save(path, st, step=st.step, meta=meta, workers=workers)
    else:
        TCK.save_sharded(path, st, step=st.step, meta=meta,
                         n_shards=n_shards, workers=workers)


def _steps(tr, st, case, lo, hi):
    rt = tr.strategy.schedule.runtime()
    for t in range(lo, hi):
        st = tr.step(st, {"real": torch.from_numpy(case["batches"][t])},
                     do_exchange=rt.is_exchange_step(t)).state
    return st


def _checkpoints(mesh, root):
    """On every rank, for each config: 3 steps, a save in each format, 3
    more (the uninterrupted run); then a fresh trainer restored from each
    save and 3 more. Returns, on rank 0, the file paths and whether each
    resumed state equals the uninterrupted one bit for bit."""
    out = {"dir": root, "resumed_equal": {}}
    for name in CKPT_CONFIGS:
        case = _ckpt_case(name, steps=6)
        tr = make_trainer(case, mesh)
        st = tr.init(T.unflatten(case["paths"], [torch.from_numpy(x)
                                                 for x in case["params"]]))
        st = _steps(tr, st, case, 0, 3)
        for fmt in CKPT_FORMATS:
            path = os.path.join(root, name, "ranks." + fmt)
            _save(fmt, path, st, case["strategy"], tr.worker_backend)
        straight = TCK.gather_workers(_steps(tr, st, case, 3, 6),
                                      tr.worker_backend)
        for fmt in CKPT_FORMATS:
            tr2 = make_trainer(case, mesh)
            like = tr2.init(T.unflatten(case["paths"], [
                torch.zeros(x.shape) for x in case["params"]]))
            path = os.path.join(root, name, "ranks." + fmt)
            TCK.verify_strategy(path, Strategy.from_json(case["strategy"]))
            back = (TCK.restore if fmt == "npz" else TCK.restore_sharded)(
                path, like, workers=tr2.worker_backend)
            resumed = TCK.gather_workers(_steps(tr2, back, case, 3, 6),
                                         tr2.worker_backend)
            same = all(
                torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                for (_, a), (_, b) in zip(TCK._paths(straight),
                                          TCK._paths(resumed)))
            out["resumed_equal"][name, fmt] = same
    return out


def _files(path):
    if path.endswith(".npz"):
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path))


@pytest.mark.parametrize("fmt", CKPT_FORMATS)
@pytest.mark.parametrize("name", CKPT_CONFIGS)
def test_rank_save_equals_the_stacked_save(ranks, name, fmt, tmp_path):
    """The 2-rank save holds exactly the files of the one-process save of
    the same state with 2 shards, member for member."""
    case = _ckpt_case(name, steps=6)
    tr = make_trainer(case)
    st = _steps(tr, tr.init(T.unflatten(case["paths"], [
        torch.from_numpy(x) for x in case["params"]])), case, 0, 3)
    ref = str(tmp_path / ("one." + fmt))
    _save(fmt, ref, st, case["strategy"], None, n_shards=2)
    got = os.path.join(ranks["ckpt_dir"], name, "ranks." + fmt)
    if fmt == "sharded":
        assert [os.path.basename(f) for f in _files(got)] == \
            [os.path.basename(f) for f in _files(ref)]
    for f, r in zip(_files(got), _files(ref)):
        if not f.endswith(".npz"):
            with open(f) as a, open(r) as b:
                assert json.load(a) == json.load(b)
            continue
        with np.load(f) as zf, np.load(r) as zr:
            assert zf.files == zr.files
            for k in zf.files:
                if k == "__meta__":
                    assert json.loads(str(zf[k])) == json.loads(str(zr[k]))
                    continue
                assert (zf[k].dtype, zf[k].shape) == (zr[k].dtype,
                                                      zr[k].shape), k
                if k.startswith(("sched/versions", "step")):
                    np.testing.assert_array_equal(zf[k], zr[k], err_msg=k)
    # the values agree to the tolerances of the backends (all_reduce sums
    # in another order than the stacked mean)
    like = tr.init(T.unflatten(case["paths"], [torch.from_numpy(x)
                                               for x in case["params"]]))
    load = TCK.restore if fmt == "npz" else TCK.restore_sharded
    ref_named = {k: v.numpy() for k, v in TCK._paths(load(ref, like))
                 if isinstance(v, torch.Tensor)}
    got_named = {k: v.numpy() for k, v in TCK._paths(load(got, like))
                 if isinstance(v, torch.Tensor)}
    assert_states_agree(ref_named, got_named, W, _n_part(name),
                        _layout(name), label=f"{name} {fmt}")


@pytest.mark.parametrize("fmt", CKPT_FORMATS)
@pytest.mark.parametrize("name", CKPT_CONFIGS)
def test_rank_save_restores_in_jax(ranks, name, fmt):
    """The JAX package restores the 2-rank save into its DQState: the
    same leaves, the W = 4 global rows, equal to what the port reads."""
    import jax.numpy as jnp
    from repro import checkpoint as JCK
    from repro.core.dqgan import DQState as JDQState
    path = os.path.join(ranks["ckpt_dir"], name, "ranks." + fmt)
    case = _ckpt_case(name)
    tr = make_trainer(case)
    like = tr.init(T.unflatten(case["paths"], [torch.from_numpy(x)
                                               for x in case["params"]]))
    port = (TCK.restore if fmt == "npz" else TCK.restore_sharded)(path, like)
    jlike = JDQState(*[TCK._rebuild(f, iter(
        jnp.zeros(tuple(x.shape), str(x.dtype).replace("torch.", ""))
        if isinstance(x, torch.Tensor) else jnp.asarray(0, jnp.int32)
        for _, x in TCK._paths(f))) for f in like])
    back = (JCK.restore if fmt == "npz" else JCK.restore_sharded)(path,
                                                                   jlike)
    assert int(back.step) == port.step == 3
    named_j = dict(TCK._paths(back))
    for k, x in TCK._paths(port):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(named_j[k]), x.numpy(),
                                          err_msg=k)
            if k.split("/")[0] in TCK.PER_WORKER_FIELDS:
                assert x.shape[0] == W, k


@pytest.mark.parametrize("fmt", CKPT_FORMATS)
@pytest.mark.parametrize("name", CKPT_CONFIGS)
def test_distributed_resume_is_bit_exact(ranks, name, fmt):
    assert ranks[2][0]["ckpt"]["resumed_equal"][name, fmt]


# --------------------------------------------------------------------------- #
# the mesh and the CLI
# --------------------------------------------------------------------------- #
def test_mesh_refuses_what_it_cannot_run():
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh(rank=1, world=2, device=torch.device("cpu"),
                       backend="gloo")
    assert mesh.rows(4) == (2, 2) and mesh.rows(2) == (1, 1)
    for n in (1, 3, 5):
        with pytest.raises(ValueError, match="do not split"):
            mesh.rows(n)
    with pytest.raises(ValueError, match="no backend"):
        ProcessMesh.init(0, 1, device_type="xla", store=None)
    if not torch.cuda.is_available():   # no fallback from the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ProcessMesh.init(0, 1, device_type="cuda")


CLI = ["--arch", "dcgan32", "--smoke", "--device", "cpu", "--workers", "4",
       "--batch", "8", "--optimizer", "omd", "--compressor",
       "qsgd8_block1024", "--comm-plan", "delta_budget", "--comm-budget-mb",
       "0.75", "--comm-adaptive", "--participation", "0.5", "--exchange",
       "two_phase", "--straggler-profile", "mild"]


def _torchrun(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"] + argv,
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def torchrun_runs(tmp_path_factory):
    """Two ranks: 3 steps with a checkpoint (2 shards, one a rank) under
    the mild straggler profile, then a resume to 5; and the one-process
    run of 5 steps."""
    from repro_torch.launch import train
    ckpt = str(tmp_path_factory.mktemp("cli") / "ckpt")
    first = _torchrun(CLI + ["--steps", "3", "--checkpoint", ckpt])
    resumed = _torchrun(CLI + ["--steps", "5", "--resume", ckpt])
    return first, resumed, train.main(CLI + ["--steps", "5"]), ckpt


def _rows(stdout):
    return [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]


def _assert_rows_agree(one, rows, exact=("round", "participants",
                                         "wire_mb_step", "cum_wire_mb",
                                         "comm_ratio")):
    assert [r["step"] for r in rows] == [r["step"] for r in one]
    for a, b in zip(one, rows):
        for k in exact:
            assert a[k] == b[k], k
        for k in ("loss", "grad_norm", "error_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7)


def test_torchrun_prints_the_one_process_rows(torchrun_runs):
    first, _, one, ckpt = torchrun_runs
    _assert_rows_agree(one[:3], _rows(first))
    assert first.count("# strategy:") == 1     # rank 0 prints
    assert sorted(os.listdir(ckpt)) == [
        "manifest.json", "shard-00000-of-00002.npz",
        "shard-00001-of-00002.npz"]


def test_torchrun_resumes_across_ranks(torchrun_runs):
    _, resumed, one, ckpt = torchrun_runs
    assert f"# resumed from {ckpt} at step 3" in resumed
    # a resumed run's ledger counts from the resume, as in one process
    _assert_rows_agree(one[3:], _rows(resumed),
                       exact=("round", "participants", "wire_mb_step"))
