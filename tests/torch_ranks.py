"""Support for the port's multi-process tests: run a function on every rank
of a gloo process group of CPU processes, and train DQGAN cases the same
way in one process (stacked workers) or across the ranks.

`run_ranks(fn, world, *args, model=1)` spawns `world` processes, each
joining the group through a `file://` store in a temporary directory (no
port), with one thread each, as a (world / model, model) mesh; `fn(mesh, *args)` runs on every rank and its results
come back in rank order. Every wait has a deadline: a rank that fails or
hangs fails the test instead of stalling the run. This module imports no
JAX, so the ranks start quickly.

`one_thread`, a module-scoped autouse fixture, runs a test module's torch
on one intra-op thread (the port's test modules import it): the suite
runs its files in parallel processes, where torch's default pool of a
thread a core in every process oversubscribes the cores many times over.
`test_torch_dqgan.py` keeps the default pool: its check of the
global-extrapolation state admits no flipped code, and at one thread the
reordered sums flip one.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _entry(rank, world, init_file, fn, args, q, model=1):
    try:
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch.mesh import ProcessMesh
        mesh = ProcessMesh.init(rank, world, device_type="cpu",
                                init_method=f"file://{init_file}",
                                timeout_s=120, model=model)
        try:
            out = fn(mesh, *args)
        finally:
            mesh.close()
        q.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world, *args, timeout=150.0, model=1):
    """[fn(mesh_r, *args) for r in range(world)], each on its own rank of
    a (world / model, model) mesh."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "group")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, init_file, fn, args, q,
                                   model))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                try:
                    rank, ok, out = q.get(timeout=max(left, 0.1))
                except queue.Empty:
                    raise AssertionError(
                        f"{world - len(results)} of {world} ranks did not "
                        f"answer within {timeout} s") from None
                if not ok:
                    raise AssertionError(f"rank {rank} failed:\n{out}")
                results[rank] = out
        finally:
            for p in procs:
                p.join(timeout=15)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
    return [results[r] for r in range(world)]


# --------------------------------------------------------------------------- #
# DQGAN cases: the mixture MLP GAN, stacked or across the ranks
# --------------------------------------------------------------------------- #
MIX = dict(name="mix", image_size=0, data_dim=2, latent_dim=16, hidden=128)
# the bilinear game of the JAX package's tests/test_distributed.py (A from
# numpy seed 0) and tests/test_overlap.py (an orthogonal A, seed 3)
BILINEAR_A = {
    "distributed": np.random.RandomState(0).randn(4, 4).astype(np.float32),
    "overlap": np.linalg.qr(np.random.RandomState(3).randn(6, 6))[0].astype(
        np.float32)}


def _bilinear(name):
    def field(params, batch, z=None, generator=None):
        import torch
        A = torch.from_numpy(BILINEAR_A[name])
        x, y = params["x"], params["y"]
        return {"x": A @ y, "y": -(A.T @ x)}, {"loss": x @ A @ y}
    return field


FIELDS = {f"bilinear_{k}": _bilinear(k) for k in BILINEAR_A}


# the four-worker cases: name -> (compression, exchange kind,
# participation fraction, schedule or None)
MIX_W, MIX_B, MIX_STEPS = 4, 64, 3
FULL = dict(compressor="qsgd8_block1024", plan="uniform", bucket_mb=0.03)
ADAPTIVE = dict(compressor="qsgd8_block1024", plan="delta_budget",
                budget_mb=0.033, bucket_mb=0.03, adaptive=True)
MIXTURE_CONFIGS = {f"{kind}_{label}": (comp, kind, frac, None)
                   for kind in ("sim", "allgather", "two_phase")
                   for label, comp, frac in (("full", FULL, 1.0),
                                             ("adaptive", ADAPTIVE, 0.5))}
MIXTURE_CONFIGS["sim_adaptive_tau_vector"] = (
    ADAPTIVE, "sim", 0.5, ("delayed_hetero", (1, 2, 3, 4)))
MIXTURE_CONFIGS["two_phase_delayed2"] = (FULL, "two_phase", 1.0,
                                         ("delayed", 2))


def mixture_params():
    """(paths, numpy leaves, params) of the mixture MLP GAN, seed 0."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import gan
    params = gan.init(gan.GANConfig(**MIX),
                      generator=torch.Generator().manual_seed(0))
    paths, leaves = T.flatten(params)
    return paths, [x.numpy() for x in leaves], params


def mixture_case(name, inject, seed=1, steps=None, overlap=False):
    """A picklable case of `name` (MIXTURE_CONFIGS), W = 4 at batch 64:
    initial params, batches and, with `inject`, every step's draws in
    their global (W, ...) layout."""
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Schedule, Strategy)
    comp, kind, frac, sched = MIXTURE_CONFIGS[name]
    W, B = MIX_W, MIX_B
    strat = Strategy(compression=Compression(**comp),
                     exchange=ExchangePlan(kind=kind, worker_axes=("data",),
                                           overlap=overlap),
                     schedule=(getattr(Schedule, sched[0])(sched[1])
                               if sched else Schedule()),
                     participation=Participation(fraction=frac))
    steps = steps or (6 if sched is not None else MIX_STEPS)
    paths, leaves, params = mixture_params()
    rs = np.random.RandomState(seed)
    case = dict(strategy=strat.to_json(), W=W, paths=paths, params=leaves,
                batches=[rs.randn(B, 2).astype(np.float32)
                         for _ in range(steps)], seed=seed)
    if inject:
        layout, _ = make_trainer(case)._comm(params)
        n = max(1, round(frac * W))
        case["draws"] = []
        for _ in range(steps):
            d = {"z": rs.randn(W, B // W, MIX["latent_dim"]).astype(
                np.float32), "rand": {}}
            if frac < 1:
                mask = np.zeros(W, np.float32)
                mask[rs.permutation(W)[:n]] = 1.0
                d["mask"] = mask
            for b in layout.buckets:
                if kind == "two_phase":
                    d["rand"][b.bid] = {
                        "phase1": rs.rand(W, W, b.size // W).astype(
                            np.float32),
                        "phase2": rs.rand(W, b.size // W).astype(np.float32)}
                else:
                    d["rand"][b.bid] = rs.rand(W, b.size).astype(np.float32)
            case["draws"].append(d)
    return case


def fsdp_strategy(zero_stage=3, kind="two_phase", moments="qsgd8_block1024",
                  overlap=False, schedule=None):
    """A four-worker fsdp strategy over the mixture GAN's uniform
    buckets: the gradient leg `kind` under qsgd8_block1024, the all-gather
    leg under `moments` (with its residual unless it is exact)."""
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      MomentCompression, Schedule, Strategy)
    lossless = moments == "identity"
    return Strategy(
        compression=Compression(**(
            dict(FULL, compressor="identity", error_feedback=False)
            if kind == "exact" else FULL)),
        exchange=ExchangePlan(kind=kind, worker_axes=("data",),
                              parallelism="fsdp", zero_stage=zero_stage,
                              overlap=overlap),
        schedule=(getattr(Schedule, schedule[0])(schedule[1])
                  if schedule else Schedule()),
        moments=MomentCompression(compressor=moments,
                                  error_feedback=not lossless))


def strategy_case(strat, seed=1, steps=MIX_STEPS, optimizer="omd"):
    """A picklable case of any strategy over the mixture GAN, W = 4 at
    batch 64: initial params and batches; the workers draw from their
    generators."""
    paths, leaves, _ = mixture_params()
    rs = np.random.RandomState(seed)
    return dict(strategy=strat.to_json(), W=MIX_W, paths=paths,
                params=leaves, seed=seed, optimizer=optimizer,
                batches=[rs.randn(MIX_B, 2).astype(np.float32)
                         for _ in range(steps)])


def _torch(x):
    import torch
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _named(state):
    from repro_torch import checkpoint as CK
    import torch
    return {n: (x.numpy().copy() if isinstance(x, torch.Tensor) else x)
            for n, x in CK._paths(state)}


def make_trainer(case, mesh=None):
    from repro_torch.configs.base import DQConfig
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.models import gan
    from repro_torch.strategy import Strategy
    strat = Strategy.from_json(case["strategy"])
    cfg = gan.GANConfig(**case.get("cfg", MIX))
    dq = DQConfig.from_strategy(strat, optimizer=case.get("optimizer", "omd"),
                                lr=case.get("lr", 1e-2), message="update")
    field = FIELDS[case["field"]] if "field" in case else gan.gan_field_fn(
        cfg)
    return DQGAN(field_fn=field, dq=dq,
                 device="cpu", workers=case["W"], mesh=mesh,
                 seed=case.get("seed", 0))


def run_case(case, mesh=None):
    """Train `case` stacked (mesh None) or on this rank; returns, on rank 0
    or without a mesh, {"state0", "state": {name: array}} (the gathered
    global state after step 0 and at the end), "metrics" (per step, the
    telemetry aside) and "masks" (the participation mask each step
    applied)."""
    import torch
    from repro_torch import checkpoint as CK
    from repro_torch import tree as T
    tr = make_trainer(case, mesh)
    params = T.unflatten(case["paths"], [_torch(x) for x in case["params"]])
    st = tr.init(params)
    wk = tr.worker_backend
    rt = tr.strategy.schedule.runtime()
    out = {"metrics": [], "masks": []}
    for t, real in enumerate(case["batches"]):
        draws = case["draws"][t] if case.get("draws") else None
        res = tr.step(st, {"real": _torch(real)},
                      None if draws is None else _torch(draws),
                      do_exchange=rt.is_exchange_step(t))
        out["masks"].append(None if res.mask is None
                            else res.mask.cpu().numpy())
        st = res.state
        out["metrics"].append({k: float(v) for k, v in res.metrics.items()
                               if k != "obs"})
        if t == 0:
            out["state0"] = _named(CK.gather_workers(st, wk))
    out["state"] = _named(CK.gather_workers(st, wk))
    if mesh is not None and mesh.rank != 0:
        return {"masks": out["masks"]}
    return out


def run_cases(mesh, cases):
    return [run_case(c, mesh) for c in cases]


def assert_states_agree(ref, got, W, n, layout=None, label=""):
    """`got` against `ref` (named global states) by the rule the port
    holds itself to across frameworks (`repro_torch.parity`)."""
    from repro_torch.parity import named_agreement
    problems = named_agreement(ref, got, W, n, layout).problems
    assert not problems, (label, problems)
