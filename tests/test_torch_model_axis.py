"""The trainer's tensor-parallel 'model' axis: the port on a (data 2,
model 2) mesh of four gloo ranks against `repro.core.dqgan.DQGAN` on the
same mesh of four forced host devices (GSPMD over 'model'), against
itself at model 1, and across checkpoints.

One JAX subprocess runs every case and writes, per case, the initial
parameters, each step's batch, metrics and draws, the wire bytes and the
final state (through `repro.checkpoint`, whose leaf names the port's
checkpoints share); the port replays them in one spawn of four ranks.
The cases:
  * gemma-2b reduced (MQA: its one KV head of 64 splits over the two
    model ranks; vocab-parallel embedding and loss), `qsgd8_linf` per
    tensor, `sim`: every sharded leaf's scale is the model group's max;
  * qwen3-moe-30b-a3b reduced (experts over 'model'), `qsgd8_block1024`
    buckets under `two_phase`: the replicated leaves bucket, the sharded
    ones take the per-tensor two_phase with the block quantizer (blocks
    inside a rank's slice, or gathered where one crosses the slices);
  * mamba2-1.3b reduced (the SSD on each rank's heads, B and C gathered
    whole), `qsgd8_linf` per tensor, `sim`;
  * recurrentgemma-2b reduced (the RG-LRU on each rank's channels, and
    MQA local attention), `qsgd8_block1024` buckets under `sim` (B1's
    plain version over the replicated leaves' buckets);
  * whisper-tiny reduced (the encoder's self-attention and the decoder's
    cross-attention head-local, learned positions replicated, the tied
    embedding vocab-parallel), `qsgd8_block1024` buckets under `sim`: its
    MLP up biases (1024 over two ranks) are flat sharded leaves whose
    slices cut B1's scale row, which B1 takes gathered;
  * dcgan32 `--smoke` through both launchers (`gen.fc` column-parallel,
    `disc.fc`'s single column replicated): the `# comm:` lines and the
    wire columns of the rows.
The JAX step's output state is held to its input's shardings, so the
three steps share one compilation.
The draws are the JAX step's own (worker key `fold_in(key, w)`, then
`split(fold_in(·, step))`; a bucket's from `fold_in(kq, 100_000 + bid)`,
a leaf's from `fold_in(kq, leaf index)`, two_phase's `split(·, W + 1)`),
made at each leaf's global shape; each model rank takes its slice.

What is compared, and how tightly (`repro_torch.parity`): the state by
its quantization-invariant part to float32 rounding of the reordered
sums (the model group's sums in the port, GSPMD's in JAX), the
parameters within one quantization step, at most 1e-3 of the residual
elements flipped; loss and grad_norm rtol 1e-5; the ledger's
wire_mb_step exactly. The replicated leaves are bit-identical on the two
model ranks of each data index after the three steps. The port at model
2 against itself at model 1 (the two workers stacked in this process) by
the same rule, on the same draws, for gemma and mamba2. A (2, 2)
checkpoint restores at one process (gemma, mamba2) and in the JAX
package, and a checkpoint of the JAX run and of the one-process run
restore on the (2, 2) mesh, leaf for leaf exactly. In the same spawn
each model group runs the sharded SSD and RG-LRU against the unsharded
functions, forward and gradients, and B1 on a flat leaf's slices
against the global leaf. The dry-run's per-rank parameter bytes equal
the JAX layout's per-device bytes for every arch.
"""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as CK
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.models import build as tbuild
from repro_torch.models import param_specs as tparam_specs
from repro_torch.parallel import sharding as tshd
from repro_torch.parallel import tensor as TP
from repro_torch.parity import named_agreement
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import run_ranks
from torch_ranks import one_thread  # noqa: F401 (autouse)

W, STEPS, B, S = 2, 3, 4, 16
LINF = dict(compressor="qsgd8_linf", plan="none")
BUCKETS = dict(compressor="qsgd8_block1024", plan="uniform")
CASES = {
    "gemma": ("gemma-2b", LINF, "sim"),
    "moe": ("qwen3-moe-30b-a3b", BUCKETS, "two_phase"),
    "mamba2": ("mamba2-1.3b", LINF, "sim"),
    "rg": ("recurrentgemma-2b", BUCKETS, "sim"),
    # its sharded MLP biases are flat leaves of 1024 that B1 takes whole
    "whisper": ("whisper-tiny", BUCKETS, "sim"),
}
# the cases also run at model 1 in this process, and checkpointed
STACKED = ("gemma", "mamba2")
CLI = ["--arch", "dcgan32", "--smoke", "--batch", "8", "--optimizer", "omd",
       "--compressor", "qsgd8_block1024", "--comm-plan", "uniform",
       "--steps", "2"]

SCRIPT = r"""
import json, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.parallel.compat import make_mesh, set_mesh
import repro.configs as cfgs
from repro import checkpoint as CK
from repro.configs.base import DQConfig
from repro.core import compressors as C
from repro.core import error_feedback as EF
from repro.core.dqgan import DQGAN, _is_plan
from repro.data import synthetic_lm_batch
from repro.models import build
from repro.parallel import sharding as shd
from repro.strategy import Strategy

W, STEPS, B, S = %(W)d, %(STEPS)d, %(B)d, %(S)d
CASES = json.loads(%(cases)r)
OUT = %(out)r
mesh = make_mesh((2, 2), ("data", "model"))
KEY = jax.random.key(7)
out = {}


def put(name, x):
    out[name] = np.asarray(jax.device_get(x))


def blocked(comp, d):
    b = comp.per_block
    return (1, d) if b <= 0 else (-(-d // b), b)


def draw(comp, key, shape):
    d = int(np.prod(shape))
    if EF.fused_compatible(comp, jax.ShapeDtypeStruct(tuple(shape),
                                                      jnp.float32)):
        return jax.random.uniform(key, (d,))
    return jax.random.uniform(key, blocked(comp, d)).reshape(-1)


def record_draws(tr, params, pre, step):
    kqs = [jax.random.split(jax.random.fold_in(
        jax.random.fold_in(KEY, w), step))[1] for w in range(W)]
    leaves = jax.tree.leaves(params)
    plans = jax.tree.leaves(tr._plans(params), is_leaf=_is_plan)
    kind = tr.strategy.exchange.kind
    streams = []
    if tr.bucketed:
        layout, cplan = tr._comm(params)
        for b, a in zip(layout.buckets, cplan.assignments):
            streams.append((str(b.bid), C.get(a.compressor), (b.size,),
                            100_000 + b.bid,
                            tr.strategy.exchange.bucket_plan(b.size, W)))
        for s in layout.skipped:
            streams.append((f"leaf/{s.index}", tr.compressor,
                            leaves[s.index].shape, s.index, plans[s.index]))
    else:
        streams = [(str(i), tr.compressor, l.shape, i, plans[i])
                   for i, l in enumerate(leaves)]
    for sid, comp, shape, fold, plan in streams:
        keys = [jax.random.fold_in(k, fold) for k in kqs]
        if plan["strategy"] == "two_phase":
            ax = plan["chunk_axis"]
            cs = (shape[ax] // W,) + tuple(d for i, d in enumerate(shape)
                                           if i != ax)
            c = int(np.prod(cs))
            ks = [jax.random.split(k, W + 1) for k in keys]
            put(f"{pre}/rand/{sid}/phase1", jnp.stack([jnp.stack(
                [jax.random.uniform(k[j], blocked(comp, c)).reshape(-1)
                 for j in range(W)]) for k in ks]))
            put(f"{pre}/rand/{sid}/phase2",
                jnp.stack([draw(comp, k[W], cs) for k in ks]))
        elif plan["strategy"] in ("sim", "allgather"):
            put(f"{pre}/rand/{sid}",
                jnp.stack([draw(comp, k, shape) for k in keys]))


with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    for name, (arch, sjson) in CASES.items():
        cfg = cfgs.get(arch).reduced()
        bundle = build(cfg)
        params = bundle.init(jax.random.key(0), max_seq=S)
        for i, x in enumerate(jax.tree.leaves(params)):
            put(f"{name}/init/{i}", x)
        pspecs = shd.param_specs(params, cfg, "dp", mesh)
        params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            pspecs, is_leaf=lambda x: hasattr(x, "shape"))
        strat = Strategy.from_json(sjson)
        tr = DQGAN(field_fn=bundle.field_fn,
                   dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-2,
                                             message="update"),
                   mesh=mesh, param_specs=pspecs, batch_spec=P(("data",)))
        put(f"{name}/wire", tr.comm_ledger(params).wire_bytes_per_step)
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
            for t in range(STEPS):
                batch = synthetic_lm_batch(
                    jax.random.fold_in(jax.random.key(1), t), B, S,
                    cfg.vocab_size)
                if cfg.is_encdec:
                    batch["enc_embeds"] = 0.1 * jax.random.normal(
                        jax.random.fold_in(jax.random.key(2), t),
                        (B, cfg.encdec.enc_seq, cfg.d_model))
                for k, v in batch.items():
                    put(f"{name}/batch/{t}/{k}", v)
                record_draws(tr, params, f"{name}/draws/{t}", t)
                res = step(st, batch, KEY)
                st = res.state
                for k in ("loss", "grad_norm"):
                    put(f"{name}/metrics/{t}/{k}", res.metrics[k])
        CK.save(f"{OUT}/{name}_jax.npz", st, step=STEPS)
        if name == "gemma":
            CK.save_sharded(f"{OUT}/gemma_jax_ckpt", st, step=STEPS,
                            meta={"strategy": strat.to_json()}, mesh=mesh)
np.savez(f"{OUT}/runs.npz", **out)
print("OK")
"""

def _strategy(comp, kind):
    from repro_torch.strategy import Compression, ExchangePlan
    return TStrategy(compression=Compression(**comp),
                     exchange=ExchangePlan(kind=kind, worker_axes=("data",)))


def _named_npz(path):
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files if k != "__meta__"}


def _named(state):
    return {n: (x.numpy().copy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.int32)) for n, x in CK._paths(state)}


def _case(data, name, t):
    """Step t's batch and draws of case `name` (numpy, the global
    layout): the rand keys are bucket ids (int) and leaf indices (int, or
    "leaf/<i>" for a leaf the buckets skip)."""
    pre = f"{name}/draws/{t}/rand/"
    rand = {}
    for k, v in data.items():
        if not k.startswith(pre):
            continue
        parts = k[len(pre):].split("/")
        if parts[0] == "leaf":
            sid, parts = f"leaf/{parts[1]}", parts[2:]
        else:
            sid, parts = int(parts[0]), parts[1:]
        if parts:
            rand.setdefault(sid, {})[parts[0]] = v
        else:
            rand[sid] = v
    batch = {k: data[f"{name}/batch/{t}/{k}"]
             for k in ("tokens", "targets", "enc_embeds")
             if f"{name}/batch/{t}/{k}" in data}
    return batch, rand


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _train(mesh, name, data, steps=STEPS):
    """Case `name` replayed on `mesh` (None: the W workers stacked in this
    process, model 1): (trainer, final state, per-step metrics)."""
    arch, comp, kind = CASES[name]
    cfg = configs.get(arch).reduced()
    bundle = tbuild(cfg, mesh)
    strat = _strategy(comp, kind)
    tr = TDQGAN(field_fn=bundle.field_fn,
                dq=TDQ.from_strategy(strat, optimizer="omd", lr=1e-2,
                                     message="update"),
                device="cpu", workers=W, mesh=mesh,
                param_specs=tparam_specs(cfg, mesh, S))
    paths, _ = T.flatten(tbuild(cfg).init(device="meta", max_seq=S))
    full = T.unflatten(paths, [_torch(data[f"{name}/init/{i}"])
                               for i in range(len(paths))])
    params = full
    if mesh is not None and mesh.model > 1:
        params = tshd.shard_tree(full, tparam_specs(cfg, mesh, S),
                                 mesh.model_index, mesh.model)
    st = tr.init(params)
    metrics = []
    for t in range(steps):
        batch, rand = _case(data, name, t)
        out = tr.step(st, _torch(batch), {"rand": _torch(rand)})
        st = out.state
        metrics.append({k: float(out.metrics[k])
                        for k in ("loss", "grad_norm")})
    return tr, st, metrics


def _global(tr, st):
    """The full global state, named (a collective under a mesh)."""
    shards = tr.state_shards(st)
    if shards is not None:
        st = shards.gather(st)
    return _named(CK.gather_workers(st, tr.worker_backend))


def _rank_runs(mesh, data, tmp, stacked_ckpt):
    """Every (2, 2) case on this rank; rank 0 returns the global states,
    every rank its replicated parameters."""
    from repro_torch.launch import train as ttrain
    out = {"replicated": {}}
    for name in CASES:
        tr, st, metrics = _train(mesh, name, data)
        shards = tr.state_shards(st)
        out[name] = {"metrics": metrics, "state": _global(tr, st),
                     "wire": tr.comm_ledger(st.params).wire_bytes_per_step,
                     # the parameters by `parallel.sharding`'s gather
                     "params": _named(tshd.gather_tree(
                         st.params, tr.param_specs, TP.model_group_for(
                             mesh)))}
        out["replicated"][name] = {
            n: x.numpy().copy() for n, x in CK._paths(st.params)
            if f"params/{n}" not in shards.leaves}
        if name in STACKED:
            CK.save_sharded(f"{tmp}/{name}_port_ckpt", st, step=st.step,
                            meta={"strategy": tr.strategy.to_json()},
                            mesh=mesh.describe(), workers=tr.worker_backend,
                            shards=shards)
        if name == "gemma":
            for src in ("gemma_jax_ckpt", stacked_ckpt):
                path = f"{tmp}/{src}"
                got = (CK.restore_sharded(path, st, workers=tr.worker_backend,
                                          shards=shards)
                       if CK.is_sharded(path) else
                       CK.restore(path, st, workers=tr.worker_backend,
                                  shards=shards))
                out[name][src] = _global(tr, got)
    out["trace"] = _obs_step(mesh, capture=True)
    out["mixers"] = {k: _mixer_tp(mesh, k) for k in MIXERS}
    out["flat"] = _flat_leaf(mesh)
    ap = ttrain.parser()
    args = ap.parse_args(CLI + ["--workers", str(W), "--device", "cpu"])
    buf = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(buf):
        rows = ttrain._train(args, ap, configs.get("dcgan32").reduced(),
                             mesh.device, mesh)
    out["cli"] = (buf.getvalue(), rows)
    if mesh.rank != 0:
        return {k: out[k] for k in ("replicated", "mixers", "flat")}
    return out


def _flat_leaf(mesh):
    """B1's compression of a flat leaf of 3072 on the rank's slice of
    1536 (the slices cut a scale row), and the slice of the global leaf's:
    (q̂, e') each."""
    from repro_torch.core import compressors as C
    from repro_torch.core.error_feedback import (LeafShard,
                                                 compress_with_ef_stacked)
    comp = C.get("qsgd8_block1024")
    g = torch.Generator().manual_seed(5)
    m, e = torch.randn((W, 3072), generator=g), torch.randn(
        (W, 3072), generator=g) * 0.01
    r = torch.rand((W, 3072), generator=g)
    group = TP.model_group_for(mesh)
    shard = LeafShard((3072,), 0, group.index, group.size, group)
    got = compress_with_ef_stacked(comp, shard.slice(m), shard.slice(e), r,
                                   shard=shard)[1:]
    want = compress_with_ef_stacked(comp, m, e, r)[1:]
    return {"got": [x.numpy() for x in got],
            "want": [shard.slice(x).numpy() for x in want]}


# the sharded mixers against the unsharded, at the archs' reduced configs
MIXERS = {"ssd": "mamba2-1.3b", "rglru": "recurrentgemma-2b"}


def _mixer_tp(mesh, kind):
    """The mixer `kind` on the rank's shards under its model group, and
    unsharded in this process, on the same inputs: its output and the
    gradients of sum(y·r) with respect to the input and every parameter
    (the sharded ones gathered whole)."""
    from repro_torch.models import mixers as M
    cfg = configs.get(MIXERS[kind]).reduced()
    g = torch.Generator().manual_seed(3)
    init, apply = ((M.rglru_init, M.rglru_apply) if kind == "rglru"
                   else (M.ssd_init, M.ssd_apply))
    full = init(cfg, generator=g)
    if kind != "rglru":     # non-trivial A_log, dt_bias and D
        full["A_log"] = torch.randn(full["A_log"].shape, generator=g) * 0.5
        full["dt_bias"] = torch.randn(full["dt_bias"].shape, generator=g)
        full["D"] = torch.randn(full["D"].shape, generator=g)
    u = torch.randn((2, 64, cfg.d_model), generator=g)
    r = torch.randn((2, 64, cfg.d_model), generator=g)
    specs = tshd.param_specs(full, cfg, "dp", mesh.shape)
    group = TP.model_group_for(mesh)

    def run(params, tp):
        paths, leaves = T.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        x = u.clone().requires_grad_()
        with TP.model_parallel(group if tp else None):
            y, _ = apply(T.unflatten(paths, leaves), cfg, x)
            grads = torch.autograd.grad((y * r).sum(), [x] + leaves)
        return y.detach(), grads[0], T.unflatten(paths, list(grads[1:]))

    paths, _ = T.flatten(full)
    y0, gx0, gp0 = run(full, False)
    y1, gx1, gp1 = run(tshd.shard_tree(full, specs, mesh.model_index,
                                       mesh.model), True)
    gp1 = tshd.gather_tree(gp1, specs, group)
    return {"y": (y0.numpy(), y1.numpy()), "x": (gx0.numpy(), gx1.numpy()),
            "params": {n: (a.numpy(), b.numpy()) for (n, a), (_, b) in zip(
                CK._paths(gp0), CK._paths(gp1))},
            "sharded": sorted("/".join(map(str, path))
                              for path, sp in zip(paths, T.flatten_up_to(
                                  paths, specs))
                              if tshd.model_axis(sp) is not None)}


def _obs_step(mesh, capture=False):
    """One dcgan32 (reduced) step, W workers, `qsgd8_linf` per tensor
    under `sim`, metrics full and spans on, on `mesh` (None: stacked, in
    this process): its metrics["obs"], and with `capture` the exchange's
    collectives by group, the bytes of the rank's leaves and the number
    of its sharded ones, and the model group's collectives by phase."""
    from repro_torch.obs import trace
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Observability)
    cfg = configs.get("dcgan32").reduced()
    bundle = tbuild(cfg, mesh)
    strat = TStrategy(compression=Compression(compressor="qsgd8_linf"),
                      exchange=ExchangePlan(kind="sim",
                                            worker_axes=("data",)),
                      observability=Observability(metrics="full",
                                                  spans=True))
    tr = TDQGAN(field_fn=bundle.field_fn, dq=TDQ.from_strategy(
        strat, optimizer="omd", lr=1e-2, message="update"), device="cpu",
        workers=W, mesh=mesh, param_specs=tparam_specs(cfg, mesh))
    st = tr.init(bundle.init(generator=torch.Generator().manual_seed(0)))
    real = torch.randn((8, 8, 8, 1), generator=torch.Generator()
                       .manual_seed(1))
    if not capture:
        return {k: v.numpy() for k, v in tr.step(st, {"real": real})
                .metrics["obs"].items()}
    out, prof = trace.capture(tr.step, st, {"real": real})
    return {"obs": {k: v.numpy() for k, v in out.metrics["obs"].items()},
            "exchange": trace.collective_summary(prof, "exchange"),
            "model": {ph: trace.collective_summary(prof, ph, "model")
                      for ph in ("field", "compress")},
            "leaf_bytes": sum(4 * x.numel() for x in T.leaves(st.params)),
            "n_leaves": len(T.leaves(st.params)),
            "n_sharded": sum(s is not None
                             for s in tr._leaf_shards(st.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, the port's one-process (model 1) gemma and mamba2
    runs with gemma's checkpoint, and the (2, 2) runs of the port."""
    from conftest import SRC, run_multidevice
    tmp = str(tmp_path_factory.mktemp("tp"))
    # the JAX launcher's run on its own 4 forced devices, beside the API
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cli = subprocess.Popen([sys.executable, "-m", "repro.launch.train"]
                           + CLI, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    cases = {n: (arch, _jax_strategy(comp, kind))
             for n, (arch, comp, kind) in CASES.items()}
    res = run_multidevice(SCRIPT % dict(
        W=W, STEPS=STEPS, B=B, S=S, cases=json.dumps(cases), out=tmp),
        n_devices=4, timeout=900)
    assert "OK" in res
    data = dict(np.load(f"{tmp}/runs.npz"))
    stacked = {name: _train(None, name, data) for name in STACKED}
    tr, st, _ = stacked["gemma"]
    CK.save(f"{tmp}/gemma_stacked.npz", st, step=st.step,
            meta={"strategy": tr.strategy.to_json()})
    port = run_ranks(_rank_runs, 4, data, tmp, "gemma_stacked.npz",
                     model=2, timeout=300)
    jax_cli, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-2000:]
    return dict(tmp=tmp, data=data, port=port, jax_cli=jax_cli,
                stacked=stacked)


def _jax_strategy(comp, kind):
    from repro.strategy import Compression, ExchangePlan, Strategy
    return Strategy(compression=Compression(**comp),
                    exchange=ExchangePlan(kind=kind,
                                          worker_axes=("data",))).to_json()


def _layout(name):
    """The bucket layout of case `name` on the (2, 2) mesh (what the e2
    rule unpacks the buckets' residuals through)."""
    from repro_torch.launch.mesh import meta_mesh
    arch, comp, kind = CASES[name]
    cfg = configs.get(arch).reduced()
    mesh = meta_mesh(4, 0, model=2)
    bundle = tbuild(cfg, mesh)
    strat = _strategy(comp, kind)
    tr = TDQGAN(field_fn=bundle.field_fn, dq=TDQ.from_strategy(
        strat, optimizer="omd", lr=1e-2, message="update"), workers=W,
        mesh=mesh, param_specs=tparam_specs(cfg, mesh, S))
    params = tshd.shard_tree(tbuild(cfg).init(device="meta", max_seq=S),
                             tparam_specs(cfg, mesh, S), 0, 2, copy=False)
    return tr._comm(params)[0] if tr.bucketed else None


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_jax_on_the_model_axis(runs, name):
    data, port = runs["data"], runs["port"][0][name]
    for t, m in enumerate(port["metrics"]):
        for k, v in m.items():
            np.testing.assert_allclose(
                v, float(data[f"{name}/metrics/{t}/{k}"]), rtol=1e-5,
                atol=1e-7, err_msg=f"{name} step {t} {k}")
    ref = _named_npz(f"{runs['tmp']}/{name}_jax.npz")
    got = {k: port["state"][k] for k in ref}
    problems = named_agreement(ref, got, W, W, _layout(name)).problems
    assert not problems, problems
    assert port["wire"] == float(data[f"{name}/wire"])
    # `gather_to_full` over the rank's shards, leaf by leaf, is the
    # checkpoint's gather
    for n, x in port["params"].items():
        assert np.array_equal(x, port["state"][f"params/{n}"]), n


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_identical_across_model_ranks(runs, name):
    reps = [r["replicated"][name] for r in runs["port"]]
    assert reps[0], "no replicated leaf"
    for a, b in ((0, 1), (2, 3)):      # the model ranks of each data index
        for n in reps[a]:
            assert np.array_equal(reps[a][n], reps[b][n]), (name, n, a, b)


def _model_two_equals_model_one(runs, name):
    tr, st, metrics = runs["stacked"][name]
    port = runs["port"][0][name]
    for a, b in zip(metrics, port["metrics"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7)
    one = _named(st)
    problems = named_agreement(one, {k: port["state"][k] for k in one},
                               W, W, _layout(name)).problems
    assert not problems, problems


@pytest.mark.multidevice
def test_model_two_equals_model_one(runs):
    _model_two_equals_model_one(runs, "gemma")


@pytest.mark.multidevice
def test_model_two_equals_model_one_on_the_ssd(runs):
    _model_two_equals_model_one(runs, "mamba2")


@pytest.mark.multidevice
def test_ssd_checkpoint_restores_at_one_process(runs):
    """mamba2's (2, 2) checkpoint restored at one process (W = 2
    stacked), leaf for leaf what the ranks gathered."""
    tr, st, _ = runs["stacked"]["mamba2"]
    port = runs["port"][0]["mamba2"]
    path = f"{runs['tmp']}/mamba2_port_ckpt"
    CK.verify_strategy(path, tr.strategy)
    back = _named(CK.restore_sharded(path, st))
    assert sorted(back) == sorted(port["state"])
    for k, v in back.items():
        assert np.array_equal(v, port["state"][k]), k


@pytest.mark.multidevice
@pytest.mark.parametrize("kind", list(MIXERS))
def test_sharded_mixer_matches_unsharded(runs, kind):
    """Each model group's sharded mixer against the unsharded function on
    the same rank: the output, the input's gradient, and every
    parameter's (B and C's, whose backward sums the ranks' heads, and the
    replicated leaves a rank uses a slice of, whose gradient comes out
    whole), to float32 rounding of the reordered sums; the gathered
    gradients are the same on both ranks of a group."""
    outs = [r["mixers"][kind] for r in runs["port"]]
    got = outs[0]
    if kind == "ssd":
        assert {"B/w", "C/w", "x/w", "dt/w", "out/w"} <= set(got["sharded"])
    if kind == "rglru":
        assert {"W_a/w", "W_a/b", "in_x/w", "out/w"} <= set(got["sharded"])
    pairs = dict(y=got["y"], x=got["x"], **{
        f"grad/{n}": v for n, v in got["params"].items()})
    for n, (want, have) in pairs.items():
        scale = float(np.abs(want).max())
        assert scale > 0, n
        np.testing.assert_allclose(have, want, rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=f"{kind} {n}")
    for a, b in ((0, 1), (2, 3)):
        for n in got["params"]:
            assert np.array_equal(outs[a]["params"][n][1],
                                  outs[b]["params"][n][1]), (kind, n)


@pytest.mark.multidevice
def test_sharded_flat_leaf_takes_b1_as_the_global_leaf(runs):
    """A flat leaf whose model slices cut B1's scale rows is compressed on
    the gathered leaf, as the JAX package compresses the global one: each
    rank's q̂ and residual are the global leaf's slices, bit for bit."""
    for r in runs["port"]:
        for got, want in zip(r["flat"]["got"], r["flat"]["want"]):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("split", ["heads", "state"])
def test_ssd_refuses_a_group_that_splits_a_head(split):
    """A model group whose size does not divide the SSD's heads (3 over
    2 ranks) or its state dimension (N = 3) is refused, not run on a split
    head or a replicated B and C (on meta)."""
    import dataclasses
    from repro_torch.models import mixers as M
    cfg = configs.get("mamba2-1.3b").reduced()
    if split == "heads":
        cfg, want = dataclasses.replace(cfg, d_model=24), "3 heads"
    else:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, state_dim=3))
        want = "3 state channels"
    p = M.ssd_init(cfg, device="meta")
    with TP.model_parallel(TP.MetaModelGroup(2, 0)):
        with pytest.raises(ValueError, match=f"{want} do not split"):
            M.ssd_apply(p, cfg, torch.zeros((1, 32, cfg.d_model),
                                            device="meta"))


@pytest.mark.multidevice
def test_checkpoints_cross_mesh_shapes_and_packages(runs):
    tmp, port = runs["tmp"], runs["port"][0]["gemma"]
    # the JAX (2, 2) run's and the one-process run's, restored at (2, 2)
    for src, ref in (("gemma_jax_ckpt", f"{tmp}/gemma_jax.npz"),
                     ("gemma_stacked.npz", f"{tmp}/gemma_stacked.npz")):
        want = _named_npz(ref)
        got = port[src]
        assert sorted(want) == sorted(got), src
        for k in want:
            assert np.array_equal(want[k], got[k]), (src, k)
    # the port's (2, 2) checkpoint at one process, W = 2 stacked
    tr, st, _ = runs["stacked"]["gemma"]
    path = f"{tmp}/gemma_port_ckpt"
    CK.verify_strategy(path, tr.strategy)
    back = _named(CK.restore_sharded(path, st))
    for k, v in back.items():
        assert np.array_equal(v, port["state"][k]), k
    assert CK.read_manifest(path)["mesh"] == {"axis_names": ["data",
                                                             "model"],
                                              "shape": [2, 2]}
    # and in the JAX package, into its DQState of the full leaves (the
    # file does not depend on the mesh it is restored on)
    import jax.numpy as jnp
    from repro import checkpoint as JCK
    from repro.core.dqgan import DQState as JDQState
    JCK.verify_strategy(path, tr.strategy)
    jlike = JDQState(*[CK._rebuild(f, iter(
        jnp.zeros(tuple(x.shape), str(x.dtype).replace("torch.", ""))
        if isinstance(x, torch.Tensor) else jnp.asarray(0, jnp.int32)
        for _, x in CK._paths(f))) for f in st])
    back = JCK.restore_sharded(path, jlike)
    assert int(back.step) == STEPS
    for k, v in CK._paths(back):
        assert np.array_equal(np.asarray(v), port["state"][k]), k


@pytest.mark.multidevice
def test_dcgan_cli_on_the_model_axis_matches_jax(runs):
    text, rows = runs["port"][0]["cli"]
    jax_comm = [ln for ln in runs["jax_cli"].splitlines()
                if ln.startswith("# comm:")]
    port_comm = [ln for ln in text.splitlines() if ln.startswith("# comm:")]
    assert port_comm == jax_comm and any("WARNING 2 sharded" in ln
                                         for ln in port_comm), port_comm
    jrows = [json.loads(ln) for ln in runs["jax_cli"].splitlines()
             if ln.startswith("{")]
    assert [r["step"] for r in rows] == [r["step"] for r in jrows]
    for a, b in zip(rows, jrows):
        for k in ("wire_mb_step", "cum_wire_mb", "comm_ratio"):
            assert a[k] == b[k], (k, a[k], b[k])
        assert np.isfinite([a["loss"], a["grad_norm"], a["error_norm"]]).all()


@pytest.mark.multidevice
def test_trace_tells_the_model_group_from_the_exchange(runs):
    """The exchange phase's data-group collectives are one all-reduce a
    leaf, of the rank's leaves' bytes (what `obs.trace.byte_gap` compares
    with the ledger); the model group's (the field's gathers, each
    sharded leaf's scale, a max over the group, in its compression)
    count apart."""
    t = runs["port"][0]["trace"]
    assert t["n_sharded"] == 2      # gen.fc's w and b
    assert t["exchange"] == {"all-reduce": {
        "count": t["n_leaves"], "bytes": t["leaf_bytes"],
        "int8_bytes": 0}}, t
    assert t["model"]["field"]["all-gather"]["count"] > 0, t
    assert t["model"]["compress"]["all-reduce"]["count"] == 2, t


@pytest.mark.multidevice
def test_telemetry_on_the_model_axis_equals_model_one(runs):
    """metrics["obs"] of the (2, 2) step against the same step with the
    two workers stacked at model 1: the sharded leaves' sums are taken
    over the model group and counted at their global size (the draws at
    the global shape are the model-1 run's own), rtol 1e-5."""
    one = _obs_step(None)
    got = runs["port"][0]["trace"]["obs"]
    assert sorted(one) == sorted(got)
    for k in one:
        np.testing.assert_allclose(got[k], one[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# --------------------------------------------------------------------------- #
# in-process: the dry-run's layout, the refusals, the launcher's rule
# --------------------------------------------------------------------------- #
IN_SCOPE = ("dcgan32", "gemma-2b", "starcoder2-7b", "yi-34b",
            "chameleon-34b", "command-r-plus-104b", "qwen3-moe-30b-a3b",
            "arctic-480b", "mamba2-1.3b", "recurrentgemma-2b",
            "whisper-tiny")


@pytest.mark.parametrize("arch", IN_SCOPE)
def test_rank_parameter_bytes_equal_the_jax_layout(arch):
    """One rank of the (16, 16) production mesh holds exactly the JAX
    layout's per-device parameter bytes (the model shards, on meta)."""
    import jax
    from repro import configs as jcfgs
    from repro.models import build as jbuild
    from repro.parallel import sharding as jshd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import meta_mesh
    mesh = meta_mesh(256, 1, model=16)
    cfg = configs.get(arch)
    local = tbuild(cfg, mesh).init(device="meta", max_seq=64)
    got = sum(x.numel() * x.element_size() for x in T.leaves(local))
    # the figure the dry-run prints for the JAX layout
    assert got == dryrun.param_bytes_per_device(cfg, "dp", mesh.shape,
                                                64)["bytes"]

    jcfg = jcfgs.get(arch)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0),
                                                      max_seq=64))
    specs = jshd.param_specs(shapes, jcfg, "dp",
                             _FakeMesh({"data": 16, "model": 16}))
    want = 0
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa
    for x, sp in zip(jax.tree.leaves(shapes),
                     jax.tree.leaves(specs, is_leaf=is_spec)):
        sharded = sum(ent is not None for ent in tuple(sp))
        want += int(np.prod(x.shape)) * x.dtype.itemsize // 16 ** sharded
    assert got == want


class _FakeMesh:
    """The {axis: size} a JAX rule reads off `mesh.shape`."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.multidevice
@pytest.mark.parametrize("arch,name", [("mamba2-1.3b", "mamba2"),
                                       ("recurrentgemma-2b", "rg"),
                                       ("whisper-tiny", "whisper")])
def test_mixers_and_encdec_train_at_model_two(runs, arch, name,
                                              monkeypatch):
    """Nothing refuses the arch at model 2: `build` lays it out over the
    mesh (its sharded leaves cut), the launcher at a world of 4 goes on
    to join its (2, 2) mesh, and the (2, 2) run of the fixture took its
    three steps with finite losses."""
    from repro_torch.launch.mesh import ProcessMesh, meta_mesh
    from repro_torch.launch import train as ttrain
    cfg = configs.get(arch).reduced()
    mesh = meta_mesh(4, 0, model=2)
    local = tbuild(cfg, mesh).init(device="meta", max_seq=S)
    full = tbuild(cfg).init(device="meta", max_seq=S)
    assert (sum(x.numel() for x in T.leaves(local))
            < sum(x.numel() for x in T.leaves(full)))
    assert tparam_specs(cfg, meta_mesh(4, 0, model=1)) is None

    class Joined(Exception):
        pass

    def from_env(device_type, model=1):
        raise Joined(model)

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(ProcessMesh, "from_env", staticmethod(from_env))
    with pytest.raises(Joined) as joined:
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--workers", "2", "--steps", "1"])
    assert joined.value.args == (2,)
    metrics = runs["port"][0][name]["metrics"]
    assert len(metrics) == STEPS
    assert all(np.isfinite(list(m.values())).all() for m in metrics)


@pytest.mark.parametrize("world,fsdp,model", [(1, False, 1), (2, False, 1),
                                              (4, False, 2), (6, False, 2),
                                              (3, False, 1), (4, True, 1),
                                              (8, False, 2)])
def test_launcher_model_axis_rule(world, fsdp, model):
    from repro_torch.launch.train import model_axis_size
    assert model_axis_size(world, fsdp) == model
