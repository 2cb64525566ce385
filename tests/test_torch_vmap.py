"""Port parity: the `spmd='vmap'` step of `repro_torch.core.dqgan` against
`repro.core.dqgan.DQGAN._step_vmap` on 4 forced host devices (a `pod`
mesh axis, the `fsdp_vmap` preset's), 3 steps of the mixture MLP GAN
with half the workers reporting each round, per-leaf qsgd8_linf (no
bucketing: the vmap step has none); also under delayed(2) with the
step's telemetry on.

The JAX vmap step derives its draws as the shard_map step does (worker
key `fold_in(fold_in(key, w), step)`, split into the field's key and kq;
leaf j from `fold_in(kq, j)`, the registry compressor's draw: vmap never
takes the fused kernel); the port replays them. What is compared, and
how tightly (tests/test_torch_multiworker.py's rule):
  * the state by `repro_torch.parity.agreement` (params − (1/n)·Σ_w e1_w
    to float32 rounding, params within one quantization step, at most
    1e-3 of the residuals flipped), the versions exactly;
  * the metrics as the vmap step defines them, not the shard_map step's:
    loss (the workers' mean), grad_norm and error_norm (global norms over
    all workers' stacked tensors, not a mean of per-worker norms), rtol
    1e-5; the staleness max and mean exactly; metrics["obs"] by
    `parity.obs_agreement` (aggregate only: no bucket keys).
Also: the vmap step calls no fused kernel where the shard_map step would,
and is refused over a process mesh.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.core import error_feedback as TEF
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import gan as TG
from repro_torch.parity import agreement, obs_agreement
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import one_thread  # noqa: F401 (autouse)

W, B, STEPS = 4, 64, 3
TCFG = TG.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                    hidden=128)
# name: (schedule kwargs or None, metrics)
CONFIGS = {"every_step": (None, "off"),
           "delayed2_obs_full": (dict(kind="delayed", tau=2), "full")}

SCRIPT = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.parallel.compat import make_mesh, set_mesh
from repro.configs.base import DQConfig
from repro.core.dqgan import DQGAN
from repro.models.gan import GANConfig, mlp_gan_init, gan_field_fn
from repro.strategy import Strategy

W, B, STEPS = %(W)d, %(B)d, %(steps)d
CONFIGS = json.loads(%(configs)r)
mesh = make_mesh((W,), ("pod",))
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


for name, sjson in CONFIGS.items():
    strat = Strategy.from_json(sjson)
    tr = DQGAN(field_fn=gan_field_fn(cfg),
               dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-2,
                                         message="update"), mesh=mesh)
    with set_mesh(mesh):
        step = jax.jit(tr.step)
        st = tr.init(params)
        for t in range(STEPS):
            pre = f"{name}/draws/{t}"
            zs, rands = [], []
            for w in range(W):
                kf, kq = jax.random.split(jax.random.fold_in(
                    jax.random.fold_in(KEY, w), t))
                zs.append(jax.random.normal(kf, (B // W, cfg.latent_dim)))
                rands.append([jax.random.uniform(jax.random.fold_in(kq, j),
                                                 (1, l.size))
                              for j, l in enumerate(jax.tree.leaves(params))])
            put(f"{pre}/z", jnp.stack(zs))
            for j in range(len(rands[0])):
                put(f"{pre}/rand/{j}", jnp.stack([r[j] for r in rands]))
            put(f"{pre}/mask", tr.strategy.participation.round_setup(
                KEY, t, W, tr.strategy.schedule.period)[0])
            real = jax.random.normal(jax.random.fold_in(
                jax.random.key(1), t), (B, 2))
            put(f"{name}/batch/{t}", real)
            res = step(st, {"real": real}, KEY)
            st = res.state
            put(f"{name}/metrics/{t}", res.metrics)
    st = jax.device_get(st)
    for i, x in enumerate(jax.tree.leaves(st.params)):
        put(f"{name}/params/{i}", x)
    for i, e in enumerate(jax.tree.leaves(
            st.ef, is_leaf=lambda x: isinstance(x, dict) and "e1" in x)):
        put(f"{name}/e1/{i}", e["e1"])
    if st.sched is not None and "versions" in st.sched:
        put(f"{name}/versions", st.sched["versions"])
for i, x in enumerate(jax.tree.leaves(params)):
    put(f"init/{i}", x)
np.savez(%(path)r, **out)
print("OK")
"""


def _strategy_json(schedule, metrics):
    from repro.strategy import (ExchangePlan, Observability, Participation,
                                Schedule, Strategy)
    return Strategy(
        exchange=ExchangePlan(kind="sim", spmd="vmap", worker_axes=("pod",)),
        schedule=Schedule(**(schedule or {})),
        participation=Participation(fraction=0.5),
        observability=Observability(metrics=metrics)).to_json()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    from conftest import run_multidevice
    path = str(tmp_path_factory.mktemp("vmap") / "runs.npz")
    configs = {n: _strategy_json(*c) for n, c in CONFIGS.items()}
    out = run_multidevice(SCRIPT % dict(W=W, B=B, steps=STEPS, path=path,
                                        configs=json.dumps(configs)),
                          n_devices=W)
    assert "OK" in out
    data = dict(np.load(path))
    os.remove(path)
    return configs, data


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CONFIGS))
def test_vmap_step_matches_jax(jax_runs, name):
    configs, data = jax_runs
    tr = TDQGAN(field_fn=TG.gan_field_fn(TCFG), device="cpu", workers=W,
                dq=TDQ.from_strategy(TStrategy.from_json(configs[name]),
                                     optimizer="omd", lr=1e-2,
                                     message="update"))
    assert tr.vmap and not tr.bucketed
    paths, _ = T.flatten(TG.init(TCFG, device="meta"))
    st = tr.init(T.unflatten(paths, [_t(data[f"init/{i}"])
                                     for i in range(len(paths))]))
    for t in range(STEPS):
        pre = f"{name}/draws/{t}/"
        draws = {"z": _t(data[pre + "z"]), "mask": _t(data[pre + "mask"]),
                 "rand": {i: _t(data[f"{pre}rand/{i}"])
                          for i in range(len(paths))}}
        out = tr.step(st, {"real": _t(data[f"{name}/batch/{t}"])}, draws)
        st = out.state
        m = f"{name}/metrics/{t}/"
        for k in ("loss", "grad_norm", "error_norm"):
            np.testing.assert_allclose(float(out.metrics[k]),
                                       float(data[m + k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {t} {k}")
        for k in ("staleness_max", "staleness_mean"):
            assert float(out.metrics[k]) == float(data[m + k]), k
        jo = {k[len(m + "obs/"):]: v for k, v in data.items()
              if k.startswith(m + "obs/")}
        if CONFIGS[name][1] == "off":
            assert "obs" not in out.metrics and not jo
        else:
            got = out.metrics["obs"]
            assert "bucket_delta" not in jo and sorted(jo) == sorted(got)
            problems = obs_agreement({k: jo[k] for k in got}, got)
            assert not problems, (t, problems)
    n = int(data[f"{name}/draws/{STEPS - 1}/mask"].sum())
    jv = data.get(f"{name}/versions")
    problems = agreement(
        ([data[f"{name}/params/{i}"] for i in range(len(paths))],
         T.flatten_up_to(paths, st.params)),
        ([data[f"{name}/e1/{i}"] for i in range(len(paths))],
         [e["e1"] for e in T.flatten_up_to(paths, st.ef)]), W, n,
        versions=None if jv is None else (jv, st.sched["versions"])).problems
    assert not problems, problems


def test_vmap_metrics_are_global_norms():
    """grad_norm is the norm over all workers' gradients at once (the
    vmap step's), not the mean of per-worker norms (the shard_map
    step's): the same step under both gives sqrt(Σ_w n_w²) against
    mean_w n_w."""
    from torch_ranks import _torch, make_trainer, strategy_case
    from repro_torch.strategy import ExchangePlan, Strategy
    runs = {}
    for spmd in ("vmap", "shard_map"):
        strat = Strategy(exchange=ExchangePlan(kind="sim", spmd=spmd,
                                               worker_axes=("data",)))
        case = strategy_case(strat, steps=1)
        tr = make_trainer(case)
        st = tr.init(T.unflatten(case["paths"],
                                 [_torch(x) for x in case["params"]]))
        runs[spmd] = tr.step(st, {"real": _torch(case["batches"][0])})
    gv = float(runs["vmap"].metrics["grad_norm"])
    gs = float(runs["shard_map"].metrics["grad_norm"])
    # each worker's norm n_w is about the same, so Σ n_w² ≈ W·mean²
    assert gv == pytest.approx(gs * W ** 0.5, rel=0.2)
    assert gv > 1.5 * gs


def test_vmap_step_takes_no_fused_kernel(monkeypatch):
    """Per-leaf qsgd8_block1024 over 1024-long vectors: the shard_map
    step compresses them through the fused kernel's wrapper, the vmap
    step never (the registry compressor's rounding)."""
    from repro_torch.strategy import Compression, ExchangePlan, Strategy
    calls = []
    real = TEF.quantize_ef_flat

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TEF, "quantize_ef_flat", spy)
    A = torch.from_numpy(np.random.RandomState(0).randn(1024, 1024).astype(
        np.float32) / 32)

    def field(params, batch, z=None, generator=None):
        x, y = params["x"], params["y"]
        return {"x": A @ y, "y": -(A.T @ x)}, {"loss": x @ A @ y}

    counts = {}
    for spmd in ("shard_map", "vmap"):
        strat = Strategy(compression=Compression(compressor="qsgd8_block1024"),
                         exchange=ExchangePlan(kind="sim", spmd=spmd,
                                               worker_axes=("data",)))
        tr = TDQGAN(field_fn=field, strategy=strat, device="cpu", workers=W)
        st = tr.init({"x": torch.ones(1024), "y": torch.ones(1024)})
        calls.clear()
        tr.step(st, {"real": torch.zeros(W, 1)})
        counts[spmd] = len(calls)
    assert counts == {"shard_map": 2, "vmap": 0}


def test_vmap_is_refused_over_a_process_mesh():
    from repro_torch.strategy import get_preset
    with pytest.raises(ValueError, match="spmd='vmap' runs on stacked "
                                         "workers only"):
        TDQGAN(field_fn=None, strategy=get_preset("fsdp_vmap"), device="cpu",
               workers=W, mesh=object())
