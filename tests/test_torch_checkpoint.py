"""Port parity: `repro_torch.checkpoint` against `repro.checkpoint`.

  * A `DQState` (each element a random value) saved by either package
    restores in the other with equal arrays (bit for bit, dtypes kept),
    per leaf and over comm buckets, under each schedule, as one `.npz` and as a `repro-sharded-v1`
    directory of 1, 2 and 4 shards; the per-leaf states keep their EF in
    bfloat16 (the `__bf16__` views). The archives hold the same member
    names, shapes and dtypes, and the same `__meta__` record.
  * The port resumes bit-exactly: 4 steps, save, restore into a fresh
    trainer, 4 more, equals 8 uninterrupted steps, per schedule (the
    trainer re-seeds its generator from (seed, step) every step).
  * `verify_strategy` refuses a checkpoint saved under another strategy
    and passes one that differs in a host-only field.
  * A JAX run checkpointed after 4 steps and continued by the port for 4
    more (the JAX step's draws replayed) matches the JAX run continued,
    to `tests/test_torch_dqgan.py`'s tolerance.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.models import gan as JG
from repro.strategy import Compression as JComp
from repro.strategy import Schedule as JSched
from repro.strategy import Strategy as JStrategy
from repro_torch import checkpoint as TCK
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.models import gan as TG
from repro_torch.strategy import Strategy as TStrategy
from test_torch_sched import (B, COMPRESSION, TCFG, assert_ef_invariant,
                              replay_draws, trainers)
from torch_ranks import one_thread  # noqa: F401 (autouse)

SCHEDULES = {"every_step": JSched.every_step(), "local_k4": JSched.local_k(4),
             "delayed1": JSched.delayed(1), "delayed2": JSched.delayed(2)}
LAYOUTS = {"per_leaf_bf16_ef": dict(COMPRESSION["per_leaf"],
                                    ef_dtype="bfloat16"),
           "bucketed": COMPRESSION["bucketed"]}
FORMATS = ("npz", "shards1", "shards2", "shards4")


def _strategy(sched, layout):
    return JStrategy(compression=JComp(**LAYOUTS[layout]),
                     schedule=SCHEDULES[sched])


def _real(t):
    return np.random.RandomState(100 + t).randn(B, 2).astype(np.float32)


def _jax_steps(jtr, step, jst, start, stop):
    """`stop − start` JAX steps through the jitted `step` of `jtr`."""
    sched = jtr.strategy.schedule.runtime()
    for t in range(start, stop):
        jst = step(jst, {"real": jnp.asarray(_real(t))}, jax.random.key(42),
                   sched.is_exchange_step(t)).state
    return jst


def _port_steps(ttr, tst, start, stop):
    sched = ttr.strategy.schedule.runtime()
    for t in range(start, stop):
        tst = ttr.step(tst, {"real": torch.from_numpy(_real(t))},
                       do_exchange=sched.is_exchange_step(t)).state
    return tst


def _save(pkg, fmt, path, state, strat):
    meta = {"strategy": strat.to_json()}
    step = int(np.asarray(state.step))
    if fmt == "npz":
        pkg.save(path, state, step=step, meta=meta)
    else:
        pkg.save_sharded(path, state, step=step, meta=meta,
                         n_shards=int(fmt[len("shards"):]))


def _restore(pkg, fmt, path, like):
    return (pkg.restore if fmt == "npz" else pkg.restore_sharded)(path, like)


def _named(tree):
    """{name: numpy array} of a state of either package."""
    out = {}
    for name, leaf in TCK._paths(tree):
        if isinstance(leaf, (torch.Tensor, int)):
            arr, bf16 = TCK._to_numpy(leaf)
            leaf = arr.view(jnp.bfloat16) if bf16 else arr
        out[name] = np.asarray(leaf)
    return out


def _assert_same_arrays(a, b):
    na, nb = _named(a), _named(b)
    assert sorted(na) == sorted(nb)
    for k in na:
        assert na[k].dtype == nb[k].dtype and na[k].shape == nb[k].shape, k
        np.testing.assert_array_equal(na[k].reshape(-1).view(np.uint8),
                                      nb[k].reshape(-1).view(np.uint8),
                                      err_msg=k)


def _filled(leaves, rs):
    """Random values of each leaf's shape and dtype (numpy): the archive
    tests need every element distinct from its zero start, not a
    trajectory."""
    out = []
    for x in leaves:
        shape, dtype = tuple(np.shape(x)), str(x.dtype).replace("torch.", "")
        if "int" in dtype:
            out.append(rs.randint(-9, 9, shape).astype(np.int32))
        else:
            out.append(rs.randn(*shape).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def states():
    """{(schedule, layout): (strategy, trainers, jitted JAX step, initial
    states of both packages and a state of each filled with random
    values at step 3)}, built once."""
    out = {}
    params = JG.init(jax.random.key(0), TCFG)
    rs = np.random.RandomState(0)
    for sched in SCHEDULES:
        for layout in LAYOUTS:
            strat = _strategy(sched, layout)
            jtr, ttr = trainers(strat)
            j0 = jtr.init(params)
            t0 = ttr.init(params_from_jax(jax.device_get(params)))
            jl, jdef = jax.tree.flatten(j0._replace(step=None))
            j3 = jax.tree.unflatten(jdef, [
                jnp.asarray(v).astype(x.dtype)
                for v, x in zip(_filled(jl, rs), jl)])._replace(
                    step=jnp.asarray(3, jnp.int32))
            tl = [x for _, x in TCK._paths(t0._replace(step=None))]
            t3 = TCK._rebuild(t0._replace(step=None), iter([
                torch.from_numpy(v).to(x.dtype)
                for v, x in zip(_filled(tl, rs), tl)]))._replace(step=3)
            out[sched, layout] = (
                strat, jtr, ttr, jax.jit(jtr.step, static_argnums=(3,)), j0,
                t0, j3, t3)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_jax_save_restores_in_the_port(states, sched, layout, fmt, tmp_path):
    strat, _, _, _, _, t0, j3, _ = states[sched, layout]
    path = str(tmp_path / ("c.npz" if fmt == "npz" else "c"))
    _save(JCK, fmt, path, j3, strat)
    back = _restore(TCK, fmt, path, t0)
    assert back.step == 3 and isinstance(back.step, int)
    _assert_same_arrays(back, j3)
    assert TCK.read_meta(path) == JCK.read_meta(path)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_port_save_restores_in_jax(states, sched, layout, fmt, tmp_path):
    strat, _, _, _, j0, _, j3, t3 = states[sched, layout]
    name = "c.npz" if fmt == "npz" else "c"
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    path = str(tmp_path / "port" / name)
    _save(TCK, fmt, path, t3, strat)
    back = jax.device_get(_restore(JCK, fmt, path, j0))
    assert int(back.step) == 3 and back.step.dtype == jnp.int32
    _assert_same_arrays(back, t3)
    # the same layout as the JAX package's own archive of its state
    ref = str(tmp_path / "jax" / name)
    _save(JCK, fmt, ref, j3, strat)
    assert TCK.read_meta(path) == JCK.read_meta(ref)
    files = [path] if fmt == "npz" else sorted(
        os.path.join(path, f) for f in os.listdir(path))
    refs = [ref] if fmt == "npz" else sorted(
        os.path.join(ref, f) for f in os.listdir(ref))
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in refs]
    for f, r in zip(files, refs):
        if f.endswith(".npz"):
            with np.load(f) as zf, np.load(r) as zr:
                assert zf.files == zr.files
                for k in zf.files:
                    assert (zf[k].dtype, zf[k].shape) == \
                        (zr[k].dtype, zr[k].shape), k


@pytest.mark.parametrize("fmt", ["npz", "shards2"])
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_port_resume_is_bit_exact(states, sched, fmt, tmp_path):
    strat, _, ttr, _, _, t0, _, _ = states[sched, "bucketed"]
    straight = _port_steps(ttr, t0, 0, 8)
    path = str(tmp_path / ("c.npz" if fmt == "npz" else "c"))
    _save(TCK, fmt, path, _port_steps(ttr, t0, 0, 4), strat)
    _, fresh = trainers(strat)
    like = fresh.init(T.tree_map(torch.zeros_like, t0.params))
    resumed = _restore(TCK, fmt, path, like)
    assert resumed.step == 4
    resumed = _port_steps(fresh, resumed, 4, 8)
    assert resumed.step == straight.step == 8
    _assert_same_arrays(resumed, straight)


def test_verify_strategy(tmp_path):
    strat = _strategy("delayed2", "bucketed")
    path = str(tmp_path / "c.npz")
    _, ttr = trainers(strat)
    params = TG.init(TCFG, generator=torch.Generator().manual_seed(0))
    TCK.save(path, ttr.init(params), step=0,
             meta={"strategy": strat.to_json()})
    same = TStrategy.from_json(strat.to_json())
    TCK.verify_strategy(path, same)
    JCK.verify_strategy(path, strat)
    host_only = same.evolve(straggler_profile="mild")
    TCK.verify_strategy(path, host_only)
    other = same.evolve(schedule="local_k", staleness_tau=1, local_k=4)
    with pytest.raises(ValueError, match="schedule.kind"):
        TCK.verify_strategy(path, other)
    with pytest.raises(ValueError, match="participation.fraction"):
        TCK.verify_strategy(path, TStrategy.from_json(strat.evolve(
            participation=0.5).to_json()))
    # a checkpoint saved by the JAX package is held the same way
    jpath = str(tmp_path / "j.npz")
    JCK.save(jpath, {"w": jnp.zeros(3)}, step=0,
             meta={"strategy": strat.to_json()})
    TCK.verify_strategy(jpath, same)
    with pytest.raises(ValueError, match="schedule.kind"):
        TCK.verify_strategy(jpath, other)


@pytest.mark.parametrize("sched", ["local_k4", "delayed2"])
def test_jax_midrun_checkpoint_continued_in_the_port(states, sched,
                                                     tmp_path):
    strat, jtr, ttr, jstep, j0, t0, _, _ = states[sched, "bucketed"]
    j4 = _jax_steps(jtr, jstep, j0, 0, 4)
    path = str(tmp_path / "mid.npz")
    _save(JCK, "npz", path, jax.device_get(j4), strat)
    j8 = jax.device_get(_jax_steps(jtr, jstep, j4, 4, 8))
    tst = TCK.restore(path, t0)
    params = JG.init(jax.random.key(0), TCFG)
    sched_rt = strat.schedule.runtime()
    for t in range(4, 8):
        draws = replay_draws(jtr, params, jax.random.key(42), t, B)
        tst = ttr.step(tst, {"real": torch.from_numpy(_real(t))}, draws,
                       do_exchange=sched_rt.is_exchange_step(t)).state
    assert tst.step == 8
    paths, _ = T.flatten(tst.params)
    assert_ef_invariant(jtr, j8, tst, paths)
