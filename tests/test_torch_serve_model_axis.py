"""Prefill and decode under the 'model' axis: the port's sharded bundle
(`models.build(cfg, mesh)`) on a data 1 x model 2 mesh of two gloo ranks,
against itself at model 1 and against the JAX package's jitted, sharded
`bundle.prefill` / `bundle.decode_step` on a (1, 2) mesh of two forced
host devices.

One JAX subprocess runs every case: parameters placed by `param_specs`
("dp"), the prompt's caches placed by `cache_specs` under each
`kv_layout` before the decode steps. It writes the initial parameters,
the inputs (numpy, seed 1), the logits of the prefill and of each decode
step, the greedy tokens and the final caches. The port takes the
parameters through `convert.params_from_jax` and replays each case in one
process and on the two ranks (one spawn). The cases, reduced (f32):
  * gemma-2b (MQA: one KV head of 64, split on head_dim under hd_model);
  * starcoder2-7b with 2 KV heads for its 4 (GQA, head-local attention);
  * gemma-2b-swa (a 46-token prompt past its window of 32: the rolling
    cache, whose slots split under seq_model);
  * qwen3-moe-30b-a3b (expert-parallel decode, a handful of tokens);
  * mamba2-1.3b (the SSD's state on a rank's heads, its conv buffer the
    rank's [x | B | C] channels);
  * recurrentgemma-2b (the RG-LRU's state on a rank's channels, and MQA
    local attention with a rolling cache);
  * whisper-tiny (the decoder's self-attention cache, the cross-attention
    projecting the replicated encoder output each step).
Each case runs prefill, then 3 greedy decode steps, under both layouts.
The dense prompts (7 tokens, max_len 16) put the first decode position on
model rank 0 and the next two on rank 1 under seq_model.

What is held, and how tightly: the logits of every step and the caches
(the ranks' parts gathered by `parallel.sharding.gather_cache`) at model
2 against model 1 and against JAX, rtol 1e-4 and atol 1e-4 in float32
(the measured gaps are ~1e-6: the model group's sums and GSPMD's are
reordered); the greedy tokens equal at every step; each rank's cache
against `shard_cache` of the JAX cache to the same tolerance, and
`gather_cache` of those shards against the JAX cache exactly.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import meta_mesh
from repro_torch.models import build, cache_specs, param_specs
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor as TP
from torch_ranks import run_ranks
from torch_ranks import one_thread  # noqa: F401 (autouse)

# name -> (arch, config changes, prompt length, max_len)
CASES = {
    "gemma": ("gemma-2b", {}, 7, 16),
    "gqa": ("starcoder2-7b", {"num_kv_heads": 2}, 7, 16),
    "swa": ("gemma-2b-swa", {}, 46, 0),
    "moe": ("qwen3-moe-30b-a3b", {}, 7, 16),
    "mamba2": ("mamba2-1.3b", {}, 32, 0),
    "rg": ("recurrentgemma-2b", {}, 46, 0),
    "whisper": ("whisper-tiny", {}, 7, 16),
}
LAYOUTS = ("hd_model", "seq_model")
B, STEPS, MAX_SEQ = 2, 3, 64
TOL = dict(rtol=1e-4, atol=1e-4)

SCRIPT = r"""
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.parallel.compat import make_mesh, set_mesh
import repro.configs as cfgs
from repro.models import build
from repro.parallel import sharding as shd

CASES = json.loads(%(cases)r)
LAYOUTS, B, STEPS, MAX_SEQ = %(layouts)r, %(B)d, %(STEPS)d, %(MAX_SEQ)d
mesh = make_mesh((1, 2), ("data", "model"))
out = {}
is_array = lambda x: hasattr(x, "shape")


def place(tree, specs):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                        tree, specs, is_leaf=is_array)


def put_tree(pre, tree):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[pre + jax.tree_util.keystr(path)] = np.asarray(x)


for name, (arch, changes, S, M) in CASES.items():
    cfg = dataclasses.replace(cfgs.get(arch).reduced(), **changes)
    bundle = build(cfg)
    params = bundle.init(jax.random.key(0), max_seq=MAX_SEQ)
    for i, x in enumerate(jax.tree.leaves(params)):
        out[f"{name}/init/{i}"] = np.asarray(x)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out[f"{name}/tokens"] = toks
    enc = None
    if cfg.is_encdec:
        enc = 0.1 * rs.randn(B, cfg.encdec.enc_seq, cfg.d_model).astype(
            np.float32)
        out[f"{name}/enc"] = enc
    params = place(params, shd.param_specs(params, cfg, "dp", mesh))
    with set_mesh(mesh):
        prefill = jax.jit(bundle.prefill, static_argnames="max_len")
        decode = jax.jit(bundle.decode_step)
        lg0, caches = prefill(params, jnp.asarray(toks), enc, max_len=M)
        for layout in LAYOUTS:
            pre = f"{name}/{layout}"
            c = place(caches, shd.cache_specs(caches, mesh, B, layout))
            lg = lg0
            for t in range(STEPS + 1):
                out[f"{pre}/logits/{t}"] = np.asarray(lg)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                out[f"{pre}/tokens/{t}"] = np.asarray(tok)
                if t < STEPS:
                    lg, c = decode(params, tok[:, None], c)
            put_tree(f"{pre}/cache", c)
np.savez(%(out)r, **out)
print("OK")
"""


def _cfg(name):
    arch, changes, _, _ = CASES[name]
    return dataclasses.replace(configs.get(arch).reduced(), **changes)


def _length(name):
    """The global length of the case's attention caches."""
    cfg, (_, _, S, M) = _cfg(name), CASES[name]
    win = cfg.attention_window
    return win if win > 0 else max(S, M)


def _inputs(data, name):
    """(cfg, the full parameters from JAX's, tokens, encoder frames)."""
    cfg = _cfg(name)
    paths, _ = T.flatten(build(cfg).init(device="meta", max_seq=MAX_SEQ))
    params = params_from_jax(T.unflatten(
        paths, [data[f"{name}/init/{i}"] for i in range(len(paths))]))
    toks = torch.from_numpy(data[f"{name}/tokens"]).long()
    enc = (torch.from_numpy(data[f"{name}/enc"]) if f"{name}/enc" in data
           else None)
    return cfg, params, toks, enc


def _named(caches):
    paths, leaves = T.flatten(caches)
    return {T.keystr(p): x.numpy().copy()
            for p, x in zip(paths, leaves) if x is not None}


def _serve(mesh, data, name, layout):
    """The case on `mesh` (None: one process): the logits and greedy tokens
    of the prefill and each decode step, and the final caches (the rank's
    own, and gathered, under a mesh)."""
    cfg, full, toks, enc = _inputs(data, name)
    bundle, params = build(cfg, mesh), full
    if mesh is not None:
        params = shd.shard_tree(full, param_specs(cfg, mesh, MAX_SEQ),
                                mesh.model_index, mesh.model)
    logits, tokens = [], []
    # kv_layout splits the cache over a model axis: one process has none
    kw = {} if mesh is None else {"kv_layout": layout}
    with torch.no_grad():
        lg, c = bundle.prefill(params, toks, enc, max_len=CASES[name][3],
                               **kw)
        for t in range(STEPS + 1):
            logits.append(lg.numpy().copy())
            tok = lg.argmax(-1)
            tokens.append(tok.numpy().copy())
            if t < STEPS:
                lg, c = bundle.decode_step(params, tok[:, None], c)
    out = {"logits": logits, "tokens": tokens}
    if mesh is None:
        out["cache"] = _named(c)
        return out
    specs = cache_specs(cfg, mesh, B, _length(name), layout)
    group = TP.model_group_for(mesh)
    out["part"] = _named(c)
    out["cache"] = _named(shd.gather_cache(c, specs, group))
    # the JAX cache cut by shard_cache, and put back by gather_cache
    ref = _jax_cache(data, name, layout, c)
    ref_part = shd.shard_cache(ref, specs, mesh.model_index, mesh.model)
    out["ref_part"] = _named(ref_part)
    out["ref_back"] = _named(shd.gather_cache(ref_part, specs, group))
    return out


def _jax_cache(data, name, layout, like):
    """The JAX run's final cache as a port tree shaped like `like`."""
    paths, _ = T.flatten(like)
    pre = f"{name}/{layout}/cache"
    return T.unflatten(paths, [
        torch.from_numpy(np.array(data[pre + T.keystr(p)]))
        if pre + T.keystr(p) in data else None for p in paths])


def _rank_runs(mesh, data):
    return {(n, lay): _serve(mesh, data, n, lay)
            for n in CASES for lay in LAYOUTS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, the port's one-process runs and its two ranks'."""
    from conftest import run_multidevice
    path = str(tmp_path_factory.mktemp("serve_tp") / "runs.npz")
    res = run_multidevice(SCRIPT % dict(
        cases=json.dumps(CASES), layouts=LAYOUTS, B=B, STEPS=STEPS,
        MAX_SEQ=MAX_SEQ, out=path), n_devices=2, timeout=600)
    assert "OK" in res
    data = dict(np.load(path))
    one = {(n, lay): _serve(None, data, n, lay)
           for n in CASES for lay in LAYOUTS}
    ranks = run_ranks(_rank_runs, 2, data, model=2, timeout=300)
    return dict(data=data, one=one, ranks=ranks)


CASE_IDS = [(n, lay) for n in CASES for lay in LAYOUTS]


@pytest.mark.multidevice
@pytest.mark.parametrize("name,layout", CASE_IDS)
def test_logits_match_model_one_and_jax(runs, name, layout):
    data, one = runs["data"], runs["one"][name, layout]
    two = runs["ranks"][0][name, layout]
    for t in range(STEPS + 1):
        want = data[f"{name}/{layout}/logits/{t}"]
        assert np.abs(want).max() > 1e-2, (name, t)   # not a vanishing case
        np.testing.assert_allclose(two["logits"][t], one["logits"][t],
                                   err_msg=f"model 2 vs 1, step {t}", **TOL)
        np.testing.assert_allclose(two["logits"][t], want,
                                   err_msg=f"model 2 vs JAX, step {t}", **TOL)
        np.testing.assert_allclose(one["logits"][t], want,
                                   err_msg=f"model 1 vs JAX, step {t}", **TOL)
    # both ranks return the same whole logits
    other = runs["ranks"][1][name, layout]
    for a, b in zip(two["logits"], other["logits"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.multidevice
@pytest.mark.parametrize("name,layout", CASE_IDS)
def test_greedy_tokens_equal_at_every_step(runs, name, layout):
    data = runs["data"]
    for t in range(STEPS + 1):
        want = data[f"{name}/{layout}/tokens/{t}"]
        for label, got in (("model 1", runs["one"][name, layout]),
                           ("model 2 rank 0", runs["ranks"][0][name, layout]),
                           ("model 2 rank 1", runs["ranks"][1][name, layout])):
            np.testing.assert_array_equal(got["tokens"][t], want,
                                          err_msg=f"{label} step {t}")


@pytest.mark.multidevice
@pytest.mark.parametrize("name,layout", CASE_IDS)
def test_gathered_caches_match_model_one_and_jax(runs, name, layout):
    data, one = runs["data"], runs["one"][name, layout]
    pre = f"{name}/{layout}/cache"
    want = {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
    assert sorted(want) == sorted(one["cache"]), name
    for r in runs["ranks"]:
        got = r[name, layout]["cache"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], one["cache"][k],
                                       err_msg=f"model 2 vs 1 {k}", **TOL)
            np.testing.assert_allclose(got[k], want[k],
                                       err_msg=f"model 2 vs JAX {k}", **TOL)
            np.testing.assert_allclose(one["cache"][k], want[k],
                                       err_msg=f"model 1 vs JAX {k}", **TOL)


@pytest.mark.multidevice
@pytest.mark.parametrize("name,layout", CASE_IDS)
def test_rank_cache_is_its_shard_of_the_reference(runs, name, layout):
    """Each rank's cache is `shard_cache` of the JAX cache (its K/V on
    head_dim or the positions, the SSD's conv buffer on its [x | B | C]
    channels), to float32 rounding; `gather_cache` puts the shards back
    exactly; the rank holds half of every split leaf."""
    pre = f"{name}/{layout}/cache"
    want = {k[len(pre):]: v for k, v in runs["data"].items()
            if k.startswith(pre)}
    split = 0
    for r in runs["ranks"]:
        got = r[name, layout]
        for k, part in got["part"].items():
            np.testing.assert_allclose(part, got["ref_part"][k],
                                       err_msg=k, **TOL)
            np.testing.assert_array_equal(got["ref_back"][k], want[k])
            if part.shape != want[k].shape:
                assert 2 * part.size == want[k].size, k
                split += 1
    assert split > 0


def test_sharded_decode_paged_refuses_with_its_reason():
    bundle = build(configs.get("gemma-2b").reduced(), meta_mesh(2, 0,
                                                                model=2))
    with pytest.raises(ValueError, match="paged engine is one process"):
        bundle.decode_paged(None, None, None, None)
    assert build(configs.get("gemma-2b").reduced()).decode_paged is not None


def test_prefill_refuses_a_layout_the_rules_do_not_know():
    bundle = build(configs.get("gemma-2b").reduced(), meta_mesh(2, 0,
                                                                model=2))
    params = bundle.init(device="meta")
    with pytest.raises(ValueError, match="hd_model|seq_model"):
        bundle.prefill(params, torch.zeros((1, 16), dtype=torch.long,
                                           device="meta"),
                       kv_layout="replicated")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_cache_that_splits_on_nothing_is_refused(layout):
    """A K/V cache whose length and head_dim both escape the model group
    (the reference replicates it) is refused by `shard_cache` and by a
    prefill under a group, not held whole by a rank."""
    cfg = dataclasses.replace(configs.get("gemma-2b").reduced(),
                              head_dim=63, d_model=252, use_rope=False)
    mesh = meta_mesh(2, 0, model=2)
    full = build(cfg).init_cache(1, 15, device="meta")
    specs = cache_specs(cfg, mesh, 1, 15, layout)
    with pytest.raises(ValueError, match="neither its length"):
        shd.shard_cache(full, specs, 0, 2)
    bundle = build(cfg, mesh)
    params = bundle.init(device="meta")
    with pytest.raises(ValueError, match="splits over 2 model ranks on "
                                         "neither"):
        bundle.prefill(params, torch.zeros((1, 15), dtype=torch.long,
                                           device="meta"), kv_layout=layout)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_init_cache_is_the_rank_part(name, layout):
    """The sharded bundle's `init_cache` is `shard_cache` of the full
    one's, leaf for leaf in shape and dtype ("pos" on the CPU), and its
    bytes are one device's under the JAX layout (`cache_specs` on a
    (1, 2) mesh)."""
    cfg = _cfg(name)
    mesh = meta_mesh(2, 1, model=2)
    L = _length(name)
    full = build(cfg).init_cache(B, L, device="meta")
    specs = cache_specs(cfg, mesh, B, L, layout)
    want = shd.shard_cache(full, specs, 1, 2)
    got = build(cfg, mesh).init_cache(B, L, device="meta", kv_layout=layout)
    wp, wl = T.flatten(want)
    gp, gl = T.flatten(got)
    assert wp == gp
    for p, a, b in zip(wp, wl, gl):
        if a is None:
            assert b is None
            continue
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device), p
        assert b.device.type == ("cpu" if p[-1] == "pos" else "meta"), p
    mesh_shape = {"data": 1, "model": 2}
    fp, fl = T.flatten(full)
    glob = T.flatten_up_to(fp, shd.cache_specs(full, mesh_shape, B, layout))
    local = sum(np.prod(shd.local_shape(tuple(x.shape), s, mesh_shape))
                * x.element_size() for x, s in zip(fl, glob) if x is not None)
    assert sum(x.numel() * x.element_size() for x in gl
               if x is not None) == local
