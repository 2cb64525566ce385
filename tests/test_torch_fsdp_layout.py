"""The fsdp parameter layout (the JAX package's Mode B): the port on a
Mode-B mesh of four gloo ranks against `repro.core.dqgan.DQGAN` on the
same mesh of four forced host devices, against itself at one process,
and across checkpoints.

Under the layout a rank holds its shard of every parameter cut over its
data and model indices (`param_specs(..., "fsdp")`), the workers are the
pods, and the field gathers each period's parameters over the data ranks
(`parallel.fsdp`). One JAX subprocess runs every reference case and
writes, per case, the initial parameters, each step's batch, metrics and
draws and the final state; the port replays them in one spawn of four
ranks:
  * "yi": yi-34b reduced, one pod on (data 2, model 2), one worker (the
    reference's single-worker step, worker axes ()), `qsgd8_block1024`
    buckets: the replicated leaves bucket (B1's plain version), the
    sharded ones take the per-tensor path, their blocks local to a
    rank's slice or gathered over both groups;
  * "moe": qwen3-moe-30b-a3b reduced at its published capacity factor
    1.25 (not `reduced()`'s 8.0, so that tokens drop), `qsgd8_linf` per
    tensor: every sharded leaf's scale is the max over both groups, and
    the global dispatch ranks the worker's tokens across the data ranks;
  * "pods": yi-34b reduced on (pod 2, data 2, model 1), two workers, the
    reference's vmap step with exchange sim, `qsgd8_block1024` per
    tensor.
The draws are the reference step's own (a single worker's key
`fold_in(key, step)`, a pod's `fold_in(fold_in(key, pod), step)`; a
bucket's from `fold_in(kq, 100_000 + bid)`, a leaf's from `fold_in(kq,
leaf index)`), made at each leaf's global shape; each rank takes its
slice.

What is compared, and how tightly (`repro_torch.parity`): the state by
its quantization-invariant part to float32 rounding, the parameters
within one quantization step, at most 1e-3 of the residual elements
flipped; loss and grad_norm rtol 1e-5. The qwen3-moe kept set (which
(token, choice) pairs fit their expert's pool) on the ranks equals the
reference's, and at least one pair drops. In the same spawn: Mode B
against one process under one seed with the drawn stream (the draws of a
leaf above one tile from its tile streams, the tile shrunk to 4096
elements so that the reduced leaves have several), the replicated leaves
bit-identical across the ranks, a Mode-B checkpoint that restores at one
process and in the JAX package (and the JAX run's on the ranks), and
Mode-B serving against one process. Without a spawn: a rank's draws
(its slice's draws plus one tile at most), a sharded leaf's blocked
quantizer on its slices (threads standing for the ranks), the stream of
a leaf of at most one tile, and the mesh's coordinates and groups.
"""
import dataclasses
import json
import math
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as CK
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.configs.base import DQConfig as TDQ
from repro_torch.core import error_feedback as EF
from repro_torch.core.dqgan import DQGAN as TDQGAN
from repro_torch.launch import mesh as M
from repro_torch.models import build as tbuild
from repro_torch.models import param_specs as tparam_specs
from repro_torch.parallel import sharding as tshd
from repro_torch.parity import named_agreement
from repro_torch.strategy import Compression, ExchangePlan
from repro_torch.strategy import Strategy as TStrategy
from torch_ranks import run_ranks
from torch_ranks import one_thread  # noqa: F401 (autouse)

STEPS, B, S = 3, 8, 16
BUCKETS = dict(compressor="qsgd8_block1024", plan="uniform")
LINF = dict(compressor="qsgd8_linf", plan="none")
BLOCK = dict(compressor="qsgd8_block1024", plan="none")
# name -> (arch, compression, pods, capacity factor or None)
CASES = {
    "yi": ("yi-34b", BUCKETS, 1, None),
    "moe": ("qwen3-moe-30b-a3b", LINF, 1, 1.25),
    "pods": ("yi-34b", BLOCK, 2, None),
}
SMALL_TILE = 4096

SCRIPT = r"""
import dataclasses, json, warnings
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
from repro.models import moe as MOE
from repro.parallel import sharding as shd
from repro.strategy import Strategy

STEPS, B, S = %(STEPS)d, %(B)d, %(S)d
CASES = json.loads(%(cases)r)
OUT = %(out)r
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


def record_draws(tr, params, pre, step, W):
    if W == 1:   # the single-worker step folds no worker index
        kqs = [jax.random.split(jax.random.fold_in(KEY, step))[1]]
    else:
        kqs = [jax.random.split(jax.random.fold_in(
            jax.random.fold_in(KEY, w), step))[1] for w in range(W)]
    leaves = jax.tree.leaves(params)
    streams = []
    if tr.bucketed:
        layout, cplan = tr._comm(params)
        for b, a in zip(layout.buckets, cplan.assignments):
            streams.append((str(b.bid), C.get(a.compressor), (b.size,),
                            100_000 + b.bid))
        for s in layout.skipped:
            streams.append((f"leaf/{s.index}", tr.compressor,
                            leaves[s.index].shape, s.index))
    else:
        streams = [(str(i), tr.compressor, l.shape, i)
                   for i, l in enumerate(leaves)]
    for sid, comp, shape, fold in streams:
        keys = [jax.random.fold_in(k, fold) for k in kqs]
        put(f"{pre}/rand/{sid}",
            jnp.stack([draw(comp, k, shape) for k in keys]))


with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    for name, (arch, sjson, pods, cf) in CASES.items():
        cfg = cfgs.get(arch).reduced()
        if cf:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        if pods == 1:
            mesh = make_mesh((2, 2), ("data", "model"))
            bspec = P("data")
        else:
            mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
            bspec = P(("pod", "data"))
        bundle = build(cfg)
        params = bundle.init(jax.random.key(0), max_seq=S)
        for i, x in enumerate(jax.tree.leaves(params)):
            put(f"{name}/init/{i}", x)
        pspecs = shd.param_specs(params, cfg, "fsdp", mesh)
        params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            pspecs, is_leaf=lambda x: hasattr(x, "shape"))
        strat = Strategy.from_json(sjson)
        tr = DQGAN(field_fn=bundle.field_fn,
                   dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-2,
                                             message="update"),
                   mesh=mesh, param_specs=pspecs,
                   batch_spec=P(("pod",)) if pods > 1 else P())
        with set_mesh(mesh):
            st = tr.init(params)
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
                for k, v in batch.items():
                    put(f"{name}/batch/{t}/{k}", v)
                batch = jax.device_put(batch, NamedSharding(mesh, bspec))
                record_draws(tr, params, f"{name}/draws/{t}", t, pods)
                res = step(st, batch, KEY)
                st = res.state
                for k in ("loss", "grad_norm"):
                    put(f"{name}/metrics/{t}/{k}", res.metrics[k])
        CK.save(f"{OUT}/{name}_jax.npz", st, step=STEPS)

    # the kept set of qwen3-moe's first MoE layer over a (B, S) batch at
    # capacity factor 1.25: which (token, choice) pairs the reference's
    # global dispatch keeps (its expert output for a one-hot gate is
    # nonzero), the routing it saw, and its output
    arch, _, _, cf = CASES["moe"]
    cfg = cfgs.get(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    p = jax.tree.map(lambda x: x[0], build(cfg).init(
        jax.random.key(0), max_seq=S)["scan"]["b0"]["moe"])
    # tokens near one direction crowd the same experts past their pools
    x = (jax.random.normal(jax.random.key(3), (1, 1, cfg.d_model))
         + 0.3 * jax.random.normal(jax.random.key(4), (B, S, cfg.d_model)))
    seen = {}
    orig = MOE._dispatch_combine

    def spy(p, cfg, xt, expert_idx, gate_vals, cap):
        seen.update(xt=xt, idx=expert_idx, gates=gate_vals, cap=cap)
        return orig(p, cfg, xt, expert_idx, gate_vals, cap)

    MOE._dispatch_combine = spy
    y, _ = MOE.moe_apply(p, cfg, x)
    MOE._dispatch_combine = orig
    keep = []
    for j in range(cfg.moe.top_k):
        g = jnp.zeros_like(seen["gates"]).at[:, j].set(1.0)
        yj = orig(p, cfg, seen["xt"], seen["idx"], g, seen["cap"])
        keep.append(jnp.any(yj != 0, axis=-1))
    put("kept/x", x)
    put("kept/y", y)
    put("kept/idx", seen["idx"])
    put("kept/keep", jnp.stack(keep, 1).reshape(-1))
    put("kept/cap", seen["cap"])
np.savez(f"{OUT}/runs.npz", **out)
print("OK")
"""


def _strategy(comp, pods):
    return TStrategy(
        compression=Compression(**comp),
        exchange=ExchangePlan(kind="sim",
                              worker_axes=("pod",) if pods > 1 else (),
                              spmd="vmap" if pods > 1 else "shard_map"))


def _cfg(name):
    arch, _, _, cf = CASES[name]
    cfg = configs.get(arch).reduced()
    if cf:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _named_npz(path):
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files if k != "__meta__"}


def _named(state):
    return {n: (x.numpy().copy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.int32)) for n, x in CK._paths(state)}


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _case(data, name, t):
    """Step t's batch and draws of case `name` (the global layout)."""
    pre = f"{name}/draws/{t}/rand/"
    rand = {}
    for k, v in data.items():
        if k.startswith(pre):
            sid = k[len(pre):]
            rand[sid if sid.startswith("leaf/") else int(sid)] = v
    batch = {k: data[f"{name}/batch/{t}/{k}"] for k in ("tokens", "targets")}
    return batch, rand


def _meta_mesh(name):
    pods = CASES[name][2]
    return M.meta_mesh(4, 0, model=2 if pods == 1 else 1, layout="fsdp",
                       pods=pods)


def _trainer(name, mesh, seed=0):
    """Case `name`'s trainer on `mesh` (None: one process, the same specs
    and so the same bucket layout), and its initial parameters' paths."""
    cfg = _cfg(name)
    pods = CASES[name][2]
    specs = tparam_specs(cfg, mesh or _meta_mesh(name), S)
    bundle = tbuild(cfg, mesh)
    return TDQGAN(field_fn=bundle.field_fn,
                  dq=TDQ.from_strategy(_strategy(CASES[name][1], pods),
                                       optimizer="omd", lr=1e-2,
                                       message="update"),
                  device="cpu", workers=pods, mesh=mesh, param_specs=specs,
                  seed=seed)


def _params(name, mesh, full):
    if mesh is None:
        return full
    return tshd.shard_tree(full, tparam_specs(_cfg(name), mesh, S),
                           **tshd.rank_cut(mesh))


def _global(tr, st):
    """The full global state, named (a collective under a mesh)."""
    shards = tr.state_shards(st)
    if shards is not None:
        st = shards.gather(st)
    return _named(CK.gather_workers(st, tr.worker_backend))


def _replay(mesh, name, data):
    """Case `name` replayed on `mesh` (None: one process) on the
    reference's draws: (trainer, final state, per-step metrics)."""
    tr = _trainer(name, mesh)
    paths, _ = T.flatten(tbuild(_cfg(name)).init(device="meta", max_seq=S))
    full = T.unflatten(paths, [_torch(data[f"{name}/init/{i}"])
                               for i in range(len(paths))])
    st = tr.init(_params(name, mesh, full))
    metrics = []
    for t in range(STEPS):
        batch, rand = _case(data, name, t)
        out = tr.step(st, _torch(batch), {"rand": _torch(rand)})
        st = out.state
        metrics.append({k: float(out.metrics[k])
                        for k in ("loss", "grad_norm")})
    return tr, st, metrics


def _drawn(mesh, name, steps=2):
    """Case `name` on `mesh` (None: one process) with the trainer's own
    draws, seed 5, the tile shrunk so that leaves have several: the
    global state and the metrics."""
    EF.DRAW_TILE = SMALL_TILE
    cfg = _cfg(name)
    tr = _trainer(name, mesh, seed=5)
    full = tbuild(cfg).init(generator=torch.Generator().manual_seed(1),
                            max_seq=S)
    st = tr.init(_params(name, mesh, full))
    rs = np.random.RandomState(2)
    metrics = []
    for _ in range(steps):
        tok = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S + 1)))
        out = tr.step(st, {"tokens": tok[:, :-1], "targets": tok[:, 1:]})
        st = out.state
        metrics.append({k: float(out.metrics[k])
                        for k in ("loss", "grad_norm", "error_norm")})
    return _global(tr, st), metrics


def _kept(mesh, data):
    """The qwen3-moe first layer's output and kept set on this rank of a
    one-pod mesh, on its rows of the reference's batch and routing."""
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import fsdp as FS
    from repro_torch.parallel import tensor as TP
    cfg = _cfg("moe")
    paths, _ = T.flatten(tbuild(cfg).init(device="meta", max_seq=S))
    i0 = [n for n, p in enumerate(paths) if p[:3] == ("scan", "b0", "moe")]
    p = T.unflatten([paths[i][3:] for i in i0],
                    [_torch(data[f"moe/init/{i}"])[0] for i in i0])
    El = cfg.moe.num_experts // mesh.model
    for k in ("gate_proj", "up_proj", "down_proj"):
        p[k] = p[k].narrow(0, mesh.model_index * El, El)
    n = B // mesh.data
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    x = _torch(data["kept/x"])[rows]
    idx = _torch(data["kept/idx"]).reshape(B, S, -1)[rows]
    fg = FS.fsdp_group_for(mesh)
    with TP.model_parallel(TP.model_group_for(mesh)), \
            FS.fsdp_parallel(fg, None):
        y, _ = tmoe.moe_apply(p, cfg, x)
        _, keep = tmoe.dispatch_keep(idx.reshape(-1).long(),
                                     cfg.moe.num_experts,
                                     int(data["kept/cap"]), fg)
    return y.numpy(), keep.numpy()


def _serve(mesh):
    """yi-34b reduced in float32: prefill of 4 rows × 12 tokens and 4
    greedy decode steps on the rank's Mode-B shards (the batch whole on
    each rank), the logits of every step."""
    cfg = _cfg("yi")
    full = tbuild(cfg).init(generator=torch.Generator().manual_seed(4),
                            max_seq=S)
    bundle = tbuild(cfg, mesh)
    params = _params("yi", mesh, full) if mesh is not None else full
    tok = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (4, 12)))
    if mesh is None:
        logits, caches = bundle.prefill(params, tok, max_len=16)
    else:
        logits, caches = bundle.prefill(params, tok, max_len=16,
                                        kv_layout="hd_model")
    out = [logits.numpy()]
    for _ in range(4):
        nxt = logits.argmax(-1, keepdim=True)
        logits, caches = bundle.decode_step(params, nxt, caches)
        out.append(logits.numpy())
    return out


def _rank_runs(mesh, label, data, tmp):
    """Every reference case of this mesh's shape on this rank; rank 0
    returns the global states, every rank its replicated parameters and
    the leaves of its state that no data rank cuts, with its fsdp group
    ((pod, model) index)."""
    out = {"replicated": {}, "uncut": {},
           "fsdp_group": (mesh.pod_index, mesh.model_index)}
    names = [n for n in CASES if CASES[n][2] == mesh.pods]
    for n in names:
        tr, st, metrics = _replay(mesh, n, data)
        shards = tr.state_shards(st)
        out[n] = {"metrics": metrics, "state": _global(tr, st)}
        out["replicated"][n] = {
            k: x.numpy().copy() for k, x in CK._paths(st.params)
            if f"params/{k}" not in shards.leaves}
        out["uncut"][n] = {
            k: (x.numpy().copy(), k in shards.leaves)
            for k, x in CK._paths(st) if torch.is_tensor(x)
            and (k not in shards.leaves or shards.leaves[k].data_axis is None)}
        if n == "yi":
            path = f"{tmp}/yi_port.npz"
            CK.save(path, st, step=st.step,
                    meta={"strategy": tr.strategy.to_json()},
                    workers=tr.worker_backend, shards=shards)
            got = CK.restore(f"{tmp}/yi_jax.npz", st,
                             workers=tr.worker_backend, shards=shards)
            out[n]["jax_restored"] = _global(tr, got)
    if mesh.pods == 1:
        out["kept"] = _kept(mesh, data)
        out["drawn"] = _drawn(mesh, "yi")
        out["serve"] = _serve(mesh)
        out["n_sharded"] = sum(
            s is not None for s in _trainer("yi", mesh)._leaf_shards(
                _params("yi", mesh, tbuild(_cfg("yi")).init(
                    device="meta", max_seq=S))))
    if mesh.rank != 0:
        return {k: out[k] for k in ("replicated", "uncut", "fsdp_group",
                                    "kept", "serve") if k in out}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, the one-process runs and the two Mode-B spawns."""
    from conftest import run_multidevice
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    cases = {n: (arch, _strategy(comp, pods).to_json(), pods, cf)
             for n, (arch, comp, pods, cf) in CASES.items()}
    res = run_multidevice(SCRIPT % dict(
        STEPS=STEPS, B=B, S=S, cases=json.dumps(cases), out=tmp),
        n_devices=4, timeout=900)
    assert "OK" in res
    data = dict(np.load(f"{tmp}/runs.npz"))
    one = _drawn(None, "yi")
    EF.DRAW_TILE = 1 << 20
    serve_one = _serve(None)
    tr, st, _ = _replay(None, "yi", data)
    CK.save(f"{tmp}/yi_one.npz", st, step=st.step)
    port = run_ranks(_rank_runs, 4, "pod1", data, tmp, model=2,
                     layout="fsdp", timeout=400)
    pods = run_ranks(_rank_runs, 4, "pod2", data, tmp, model=1,
                     layout="fsdp", pods=2, timeout=300)
    return dict(tmp=tmp, data=data, port=port, pods=pods, one=one,
                serve_one=serve_one, one_state=_named(st), one_tr=tr)


def _layout(name):
    tr = _trainer(name, None)
    if not tr.bucketed:
        return None
    full = tbuild(_cfg(name)).init(device="meta", max_seq=S)
    return tr._comm(full)[0]


def _port(runs, name):
    return (runs["pods"] if CASES[name][2] == 2 else runs["port"])


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CASES))
def test_mode_b_matches_jax(runs, name):
    data, port = runs["data"], _port(runs, name)[0][name]
    for t, m in enumerate(port["metrics"]):
        for k, v in m.items():
            np.testing.assert_allclose(
                v, float(data[f"{name}/metrics/{t}/{k}"]), rtol=1e-5,
                atol=1e-7, err_msg=f"{name} step {t} {k}")
    ref = _named_npz(f"{runs['tmp']}/{name}_jax.npz")
    got = {k: port["state"][k] for k in ref}
    W = CASES[name][2]
    problems = named_agreement(ref, got, W, W, _layout(name)).problems
    assert not problems, problems


@pytest.mark.multidevice
@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_identical_across_ranks(runs, name):
    ranks = _port(runs, name)
    reps = [r["replicated"][name] for r in ranks]
    assert reps[0], "no replicated leaf"
    for r in reps[1:]:
        for n in reps[0]:
            assert np.array_equal(reps[0][n], r[n]), (name, n)
    # every leaf of the state that no data rank cuts (the replicated ones,
    # the shards of those cut over 'model' alone, their residuals) is one
    # value across each fsdp group
    groups = {}
    for r in ranks:
        groups.setdefault(r["fsdp_group"], []).append(r["uncut"][name])
    assert all(len(g) == 2 for g in groups.values()), groups.keys()
    for g in groups.values():
        assert list(g[0]) == list(g[1]), name
        for n, (x, _) in g[0].items():
            assert np.array_equal(x, g[1][n][0]), (name, n)
    if CASES[name][2] == 1:     # (data 2, model 2): model shards, e1 too
        cut = [n for n, (_, c) in g[0].items() if c]
        assert "params/embed" in cut, cut
        assert any(n.endswith("/embed/e1") for n in cut), cut


@pytest.mark.multidevice
def test_moe_drops_tokens_and_keeps_the_reference_set(runs):
    data = runs["data"]
    parts = [r["kept"] for r in runs["port"]]
    # ranks (data 0, model 0) and (data 1, model 0) hold the two halves
    keep = np.concatenate([parts[0][1], parts[2][1]])
    want = data["kept/keep"].astype(bool)
    assert (~want).sum() >= 1, "no token dropped at capacity factor 1.25"
    assert np.array_equal(keep, want)
    y = np.concatenate([parts[0][0], parts[2][0]])
    np.testing.assert_allclose(y, data["kept/y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(parts[0][0], parts[1][0])


@pytest.mark.multidevice
def test_mode_b_equals_one_process_under_one_seed(runs):
    state, metrics = runs["port"][0]["drawn"]
    one_state, one_metrics = runs["one"]
    for a, b in zip(one_metrics, metrics):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7)
    problems = named_agreement(one_state, state, 1, 1,
                               _layout("yi")).problems
    assert not problems, problems
    assert runs["port"][0]["n_sharded"] > 0


@pytest.mark.multidevice
def test_mode_b_checkpoint_crosses_processes_and_packages(runs):
    tmp, port = runs["tmp"], runs["port"][0]["yi"]
    # the JAX run's checkpoint on the Mode-B ranks
    want = _named_npz(f"{tmp}/yi_jax.npz")
    assert sorted(want) == sorted(port["jax_restored"])
    for k in want:
        assert np.array_equal(want[k], port["jax_restored"][k]), k
    # the ranks' checkpoint at one process, the full leaves
    tr = runs["one_tr"]
    like = tr.init(tbuild(_cfg("yi")).init(max_seq=S))
    back = _named(CK.restore(f"{tmp}/yi_port.npz", like))
    for k, v in back.items():
        assert np.array_equal(v, port["state"][k]), k
    # and in the JAX package, into its DQState of the full leaves
    import jax.numpy as jnp
    from repro import checkpoint as JCK
    from repro.core.dqgan import DQState as JDQState
    jlike = JDQState(*[CK._rebuild(f, iter(
        jnp.zeros(tuple(x.shape), str(x.dtype).replace("torch.", ""))
        if isinstance(x, torch.Tensor) else jnp.asarray(0, jnp.int32)
        for _, x in CK._paths(f))) for f in like])
    back = JCK.restore(f"{tmp}/yi_port.npz", jlike)
    assert int(back.step) == STEPS
    for k, v in CK._paths(back):
        assert np.array_equal(np.asarray(v), port["state"][k]), k


def _restore_yi(mesh, path):
    tr = _trainer("yi", mesh)
    like = tr.init(_params("yi", mesh, tbuild(_cfg("yi")).init(max_seq=S)))
    got = CK.restore(path, like, workers=tr.worker_backend,
                     shards=tr.state_shards(like))
    return _global(tr, got)


@pytest.mark.multidevice
def test_one_process_checkpoint_restores_on_the_mode_b_ranks(runs):
    got = run_ranks(_restore_yi, 4, f"{runs['tmp']}/yi_one.npz", model=2,
                    layout="fsdp", timeout=120)[0]
    for k, v in runs["one_state"].items():
        assert np.array_equal(v, got[k]), k


@pytest.mark.multidevice
def test_mode_b_serving_equals_one_process(runs):
    for r in runs["port"]:
        for t, (a, b) in enumerate(zip(runs["serve_one"], r["serve"])):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {t}")
            assert np.array_equal(a.argmax(-1), b.argmax(-1)), t


# --------------------------------------------------------------------------- #
# a rank's draws, without a spawn
# --------------------------------------------------------------------------- #
SHARDS = {
    # (shape, model cut (axis, index, size), data cut (axis, index, size))
    "column": ((3, 40, 24), (2, 1, 4), (1, 3, 4)),
    "row": ((3, 24, 40), (1, 2, 4), (2, 0, 4)),
    "experts": ((2, 8, 12, 10), (1, 1, 2), (2, 1, 2)),
    "data_only": ((7, 48), (None, 0, 1), (1, 2, 3)),
    "model_only": ((64, 9), (0, 3, 4), (None, 0, 1)),
}


@pytest.mark.parametrize("name", list(SHARDS))
def test_rank_draws_hold_their_slice_and_one_tile(monkeypatch, name):
    shape, (ma, mi, ms), (da, di, ds) = SHARDS[name]
    monkeypatch.setattr(EF, "DRAW_TILE", 100)
    shard = EF.LeafShard(shape, ma, mi, ms, None, da, di, ds, None)
    n = math.prod(shape)
    whole = EF.tile_draws(77, n, 0, n, "cpu")
    made, held = [], []
    tile = EF._tile

    def counting(*args):
        # the tiles made before this one that are still alive
        held.append(sum(r() is not None for r in made))
        x = tile(*args)
        made.append(weakref.ref(x))
        return x
    monkeypatch.setattr(EF, "_tile", counting)
    k = math.prod(shard.local_shape)
    want = shard.take(whole[None])
    got = EF.DrawChunks([77], n, shard, "cpu").take(0, k)
    assert torch.equal(got, want) and got.shape == (1, k)
    assert made and max(held) == 0      # the slice's draws and one tile
    assert k + 100 < n
    # read in ranges, two rows: each row its stream's, one tile at a time
    other = shard.take(EF.tile_draws(78, n, 0, n, "cpu")[None])
    chunks = EF.DrawChunks([77, 78], n, shard, "cpu")
    cuts = [0, 7, k // 2, k - 1, k]
    got = torch.cat([chunks.take(a, z) for a, z in zip(cuts, cuts[1:])], 1)
    assert torch.equal(got, torch.cat([want, other]))
    assert max(held) == 0
    # a range of the stream is the whole stream's range
    assert torch.equal(EF.tile_draws(77, n, 37, 251, "cpu"), whole[37:251])


class _Team:
    """Threads standing for the ranks of one group: `all_reduce` sums (or
    maxes) their tensors, in one order on every member."""

    def __init__(self, n):
        self.size, self.bar, self.box = n, threading.Barrier(n), [None] * n

    def member(self, i):
        team = self

        class Member:
            size = team.size

            def all_reduce(self, x, op=None):
                team.box[i] = x.clone()
                team.bar.wait()
                parts = torch.stack(team.box)
                x.copy_(parts.amax(0) if op == torch.distributed.ReduceOp.MAX
                        else parts.sum(0))
                team.bar.wait()
                return x
        return Member()


@pytest.mark.parametrize("norm", ["linf", "l2"])
@pytest.mark.parametrize("shape,mode", [((2, 8, 32), "local"),
                                        ((2, 6, 40), "gather")])
def test_blocked_slices_match_the_global_quantizer(norm, shape, mode):
    """A sharded leaf's blocked quantizer on four ranks' slices (data 2 on
    dimension 1, model 2 on dimension 2, threads for ranks): its blocks'
    scales local or reduced over the groups, m_hat the global
    quantizer's, and in "local" mode its payload the slice's blocks as
    `compress_rows` makes them."""
    from repro_torch.core import compressors as C
    comp = C.StochasticQuant(name="q", bits=8, norm=norm, per_block=16)
    g = torch.Generator().manual_seed(3)
    full = torch.randn((1,) + shape, generator=g)
    rand = torch.rand((1, math.prod(shape)), generator=g)
    want = comp.decompress(comp.compress(full.reshape(-1), rand[0]),
                           full.shape, full.dtype)
    model = [_Team(2) for _ in range(2)]       # one a data index
    data = [_Team(2) for _ in range(2)]        # one a model index
    out = {}

    def rank(d, m):
        shard = EF.LeafShard(shape, 2, m, 2, model[d].member(m), 1, d, 2,
                             data[m].member(d))
        x = shard.slice(full)
        pl, got = EF._compress_sharded(comp, x.clone(), rand, None, shard,
                                       payload=mode == "local")
        out[d, m] = shard, x, pl, got
    threads = [threading.Thread(target=rank, args=(d, m))
               for d in range(2) for m in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 4
    for shard, x, pl, got in out.values():
        assert shard.mode(comp) == mode
        if mode == "local" or norm == "linf":
            assert torch.equal(got, shard.slice(want))
        else:       # a root sum of squares summed in another order
            torch.testing.assert_close(got, shard.slice(want), rtol=1e-5,
                                       atol=1e-6)
        if mode == "local":
            ref = EF.compress_rows(comp, x, shard.take(rand))
            assert all(torch.equal(pl[k], ref[k]) for k in ref)
        else:
            assert pl is None


def test_a_leaf_of_one_tile_keeps_the_generators_stream():
    from repro_torch.core import compressors as C
    comp = C.get("qsgd8_linf")
    m = torch.randn(1, 64, 32)
    e = torch.zeros_like(m)
    outs = []
    for stream in (None, [EF.leaf_stream(9, 3)]):
        g = torch.Generator().manual_seed(11)
        outs.append(EF.compress_with_ef_stacked(comp, m, e, None, g,
                                                stream=stream))
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(a, b)
    # above one tile the stream, not the generator, draws
    assert EF.stream_draws(comp, 1, 64 * 32, [1], "cpu") is None
    assert EF.stream_draws(comp, 1, EF.DRAW_TILE + 1, [1], "cpu").shape \
        == (1, EF.DRAW_TILE + 1)


# --------------------------------------------------------------------------- #
# the mesh, without a spawn
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pods,data,model", [(1, 2, 2), (2, 2, 1),
                                             (2, 16, 16), (1, 16, 16)])
def test_mode_b_mesh_coordinates_and_groups(pods, data, model):
    world = pods * data * model
    groups = M.groups(pods, data, model)
    by_kind = {}
    for kind, members in groups:
        by_kind.setdefault(kind, []).append(members)
    for kind, n_groups, size in (("exchange", data * model, pods),
                                 ("fsdp", pods * model, data),
                                 ("model", pods * data, model)):
        g = by_kind[kind]
        assert len(g) == n_groups and all(len(m) == size for m in g)
        assert sorted(r for m in g for r in m) == list(range(world))
    for r in (0, world - 1, world // 2 + 1):
        mesh = M.meta_mesh(world, r, model=model, layout="fsdp", pods=pods)
        p, i, j = mesh.pod_index, mesh.data_index, mesh.model_index
        assert (p * data + i) * model + j == r
        mine = {k: [m for kk, m in groups if kk == k and r in m][0]
                for k in by_kind}
        assert all(M.meta_mesh(world, q, model=model, layout="fsdp",
                               pods=pods).data_index == i
                   and M.meta_mesh(world, q, model=model, layout="fsdp",
                                   pods=pods).model_index == j
                   for q in mine["exchange"])
        assert mine["fsdp"] == [(p * data + d) * model + j
                                for d in range(data)]
        assert mine["model"] == [(p * data + i) * model + m
                                 for m in range(model)]
        assert mesh.rows(pods) == (p, 1)
        with pytest.raises(ValueError, match="workers are the"):
            mesh.rows(pods * 2)
        assert mesh.describe() == {"axis_names": ["pod", "data", "model"],
                                   "shape": [pods, data, model]}
        want = {"data": data, "model": model}
        if pods > 1:
            want = {"pod": pods, **want}
        assert mesh.shape == want
    # a dp mesh is as before
    dp = M.meta_mesh(8, 5, model=2)
    assert (dp.data_index, dp.model_index, dp.n_exchange) == (2, 1, 4)
    assert dp.rows(8) == (4, 2) and dp.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="pod axis needs the fsdp"):
        M.meta_mesh(8, 0, pods=2)
