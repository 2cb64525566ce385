"""Port parity: `repro_torch.comm` (buckets, planner, ledger) and the static
part of `repro_torch.core.exchange` against `repro`. These are host-side
integer computations, so every number must be equal, not close."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import comm as JComm
from repro.configs import get as jget
from repro.core import exchange as JX
from repro.models import gan as jgan
from repro_torch import comm as TComm
from repro_torch import tree as T
from repro_torch.core import exchange as TX

FULL = jget("dcgan32")
SMALL = FULL.reduced()
# (config, bucket MiB): the full width in 4 MiB buckets (3 buckets), and the
# reduced config in 0.02 MiB buckets (several buckets)
LAYOUTS = [(FULL, 4.0), (SMALL, 0.02)]
BASES = ["qsgd8_block1024", "qsgd8_linf", "qsgd4_block1024", "topk1",
         "sign", "identity"]


def _shapes(cfg):
    params = jax.eval_shape(lambda: jgan.init(jax.random.key(0), cfg))
    return jax.tree.map(lambda x: tuple(x.shape), params)


def _layouts(cfg, mb, W):
    shapes = _shapes(cfg)
    nbytes = int(mb * (1 << 20))
    return (JComm.build_layout(shapes, None, W, nbytes),
            TComm.build_layout(shapes, None, W, nbytes))


def _astuple(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("cfg,mb", LAYOUTS, ids=["dcgan32", "reduced"])
@pytest.mark.parametrize("W", [1, 2, 8])
def test_layout_equal(cfg, mb, W):
    lj, lt = _layouts(cfg, mb, W)
    assert [_astuple(b) for b in lt.buckets] == [_astuple(b)
                                                 for b in lj.buckets]
    assert lt.skipped == () and lj.skipped == ()
    assert (lt.n_workers, lt.align, lt.n_leaves) == (lj.n_workers, lj.align,
                                                     lj.n_leaves)
    assert lt.describe() == lj.describe()
    if cfg is SMALL:
        assert len(lt.buckets) >= 2


def test_dcgan32_layout_is_three_buckets():
    _, lt = _layouts(FULL, 4.0, 1)
    assert lt.describe().startswith("3 buckets (1849988 elems, 0.1% pad)")
    assert [b.size // 1024 for b in lt.buckets] == [648, 648, 512]


@pytest.mark.parametrize("cfg,mb", LAYOUTS, ids=["dcgan32", "reduced"])
@pytest.mark.parametrize("policy", ["uniform", "size_tiered",
                                    "delta_budget"])
@pytest.mark.parametrize("base", BASES)
def test_plan_equal(cfg, mb, policy, base):
    lj, lt = _layouts(cfg, mb, 2)
    budget = (lt.padded_elems // 2 if policy == "delta_budget" else 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # floor overruns warn in both
        pj = JComm.plan_comm(lj, base, policy, budget)
        pt = TComm.plan_comm(lt, base, policy, budget)
    assert [_astuple(a) for a in pt.assignments] == [_astuple(a)
                                                     for a in pj.assignments]
    assert pt.describe() == pj.describe()
    assert pt.payload_bytes == pj.payload_bytes


def test_quant_ladder_equal():
    from repro.comm.planner import quant_ladder as jl
    from repro_torch.comm.planner import quant_ladder as tl
    from repro.core.compressors import REGISTRY
    for name in sorted(REGISTRY):
        try:
            want = jl(name)
        except ValueError:
            with pytest.raises(ValueError):
                tl(name)
            continue
        assert tl(name) == want


@pytest.mark.parametrize("cfg,mb", LAYOUTS, ids=["dcgan32", "reduced"])
@pytest.mark.parametrize("kind", ["sim", "exact", "allgather", "two_phase"])
@pytest.mark.parametrize("W", [1, 8])
def test_ledger_from_plan_equal(cfg, mb, kind, W):
    lj, lt = _layouts(cfg, mb, W)
    base = "qsgd8_block1024"
    pj = JComm.plan_comm(lj, base, "size_tiered")
    pt = TComm.plan_comm(lt, base, "size_tiered")
    gj = JComm.CommLedger.from_plan(lj, pj, kind, W, base)
    gt = TComm.CommLedger.from_plan(lt, pt, kind, W, base)
    for _ in range(3):
        gj.tick()
        gt.tick()
    assert gt.summary() == gj.summary()
    assert [_astuple(e) for e in gt.entries] == [_astuple(e)
                                                 for e in gj.entries]


@pytest.mark.parametrize("kind", ["sim", "exact", "allgather", "two_phase"])
@pytest.mark.parametrize("comp", ["qsgd8_linf", "qsgd8_block1024", "topk10",
                                  "sign", "identity"])
@pytest.mark.parametrize("W", [1, 4])
def test_ledger_from_tree_equal(kind, comp, W):
    shapes = _shapes(FULL)
    gj = JComm.CommLedger.from_tree(kind, comp, shapes, None, W)
    gt = TComm.CommLedger.from_tree(kind, comp, shapes, None, W)
    gj.tick(2)
    gt.tick(2)
    assert gt.summary() == gj.summary()
    assert [e.tag for e in gt.entries] == [e.tag for e in gj.entries]


def test_pack_unpack_equal():
    _, lt = _layouts(SMALL, 0.02, 1)
    lj, _ = _layouts(SMALL, 0.02, 1)
    rs = np.random.RandomState(0)
    paths, shapes = T.flatten(_shapes(SMALL))
    leaves = [rs.randn(*s).astype(np.float32) for s in shapes]
    fj = JComm.pack(lj, [jnp.asarray(x) for x in leaves])
    ft = TComm.pack(lt, [torch.from_numpy(x) for x in leaves])
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = TComm.unpack_into(lt, ft, [torch.zeros(s) for s in shapes])
    for x, y in zip(leaves, back):
        np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("W", [None, 1, 4])
def test_pack_concat_is_the_jax_buckets_back_to_back(W):
    """The one-buffer packing behind `pack` and the one-launch exchange:
    the JAX package's buckets one after another, each a row-major (W,
    size) block (leaves with or without a worker axis), cut back into the
    same buckets as contiguous views by split_concat, and unpacked to the
    leaves."""
    from repro_torch.comm import buckets as TB
    _, lt = _layouts(SMALL, 0.02, 1)
    lj, _ = _layouts(SMALL, 0.02, 1)
    assert len(lt.buckets) > 1
    rs = np.random.RandomState(1)
    paths, shapes = T.flatten(_shapes(SMALL))
    lead = () if W is None else (W,)
    leaves = [rs.randn(*lead, *s).astype(np.float32) for s in shapes]
    flat = TB.pack_concat(lt, [torch.from_numpy(x) for x in leaves])
    assert tuple(flat.shape) == ((W or 1) * lt.padded_elems,)
    jflats = [[np.asarray(f) for f in JComm.pack(
        lj, [jnp.asarray(x[w] if lead else x) for x in leaves])]
        for w in range(W or 1)]
    parts = TB.split_concat(lt, flat, lead)
    start = 0
    for b, part in zip(lt.buckets, parts):
        assert part.data_ptr() == flat.data_ptr() + 4 * start   # a view
        assert part.is_contiguous() and part.shape == lead + (b.size,)
        start += (W or 1) * b.size
        for w in range(W or 1):
            np.testing.assert_array_equal(
                (part[w] if lead else part).numpy(), jflats[w][b.bid])
    packed = TComm.pack(lt, [torch.from_numpy(x) for x in leaves])
    for a, b in zip(packed, parts):
        assert torch.equal(a, b)
    back = TComm.unpack_into(lt, parts,
                             [torch.zeros(lead + s) for s in shapes])
    for x, y in zip(leaves, back):
        np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("kind", ["sim", "exact", "allgather", "two_phase"])
@pytest.mark.parametrize("W", [1, 2, 8])
def test_leaf_and_bucket_plans_equal(kind, W):
    shapes = _shapes(FULL)
    specs = jax.tree.map(lambda _: P(), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    pj = JX.plan_for_tree(kind, shapes, specs, W)
    pt = TX.plan_for_tree(kind, shapes, None, W)
    paths, _ = T.flatten(shapes)
    assert T.flatten_up_to(paths, pt) == T.flatten_up_to(paths, pj)
    for size in (1024 * W, 648 * 1024 * W):
        assert TX.plan_bucket(kind, size, W) == JX.plan_bucket(kind, size, W)
    for pl, shape in zip(T.flatten_up_to(paths, pt), T.leaves(shapes)):
        zj = JX.ef_state_zeros(pl, shape, jnp.float32, W, True)
        zt = TX.ef_state_zeros(pl, shape, torch.float32, W, True)
        assert {k: tuple(v.shape) for k, v in zt.items()} == \
            {k: tuple(v.shape) for k, v in zj.items()}


def test_sharded_leaves_skip_the_buckets():
    """Spec'd leaves stay on the per-tensor path (the port's specs are
    per-dimension axis tuples, the JAX package's PartitionSpecs)."""
    shapes = {"a": (64, 32), "b": (128,), "c": (16, 16)}
    jspecs = {"a": P(None, "model"), "b": P(), "c": P("data", None)}
    tspecs = {"a": (None, "model"), "b": (), "c": ("data", None)}
    lj = JComm.build_layout(shapes, jspecs, 4, 4096)
    lt = TComm.build_layout(shapes, tspecs, 4, 4096)
    assert [_astuple(b) for b in lt.buckets] == [_astuple(b)
                                                 for b in lj.buckets]
    assert [_astuple(s) for s in lt.skipped] == [_astuple(s)
                                                 for s in lj.skipped]
    assert len(lt.skipped) == 2
