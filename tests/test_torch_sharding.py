"""Port parity of the partition rules (`repro_torch.parallel.sharding`),
the production meshes (`repro_torch.launch.mesh`) and the meta
stand-ins (`repro_torch.launch.specs`) against `repro.parallel.sharding`,
`repro.launch.mesh` and `repro.launch.specs`, at published widths: the
JAX side on `jax.eval_shape` trees, the port on meta tensors. Specs
compare exactly, as tuples, leaf for leaf by path. A mesh is a
production one, a `FakeMesh` with a `shape` dict on the JAX side (as
`tests/test_substrate.py` builds it) and the {axis: size} dict on the
port's."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as jcfgs
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import build as jbuild
from repro.parallel import compat as jcompat
from repro.parallel import sharding as jshd
from repro_torch import configs as tcfgs
from repro_torch import tree as T
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.parallel import sharding as tshd
from torch_ranks import one_thread  # noqa: F401 (autouse)

ARCHS = list(jcfgs.ASSIGNED) + ["gemma-2b-swa"]
MESHES = {"single": (False, ""), "multi": (True, "")}
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _fake(mesh):
    class FakeMesh:
        shape = dict(mesh)
    return FakeMesh


def _norm(spec):
    """A JAX spec as a tuple, one axis by its name (JAX versions differ in
    whether P(("data",)) keeps the tuple; the meaning is the same)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_by_path(tree, specs):
    """{keystr: spec tuple} of a JAX spec tree over `tree`'s leaves."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(paths) == len(leaves)
    return {p: _norm(s) for p, s in zip(paths, leaves)}


def _port_by_path(specs):
    paths, leaves = T.flatten(specs)
    return {T.keystr(p): s for p, s in zip(paths, leaves) if s is not None}


def _port_leaves(tree):
    """{keystr: (shape, dtype name)} of a port tree's tensors."""
    paths, leaves = T.flatten(tree)
    return {T.keystr(p): (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in zip(paths, leaves) if isinstance(x, torch.Tensor)}


def _tensors_by_path(tree):
    paths, leaves = T.flatten(tree)
    return [(T.keystr(p), x) for p, x in zip(paths, leaves)
            if isinstance(x, torch.Tensor)]


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    b = jbuild(jcfgs.get(arch))
    return jax.eval_shape(lambda: b.init(jax.random.key(0), 8))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tspecs.abstract_params(tcfgs.get(arch),
                                  tmesh.production_mesh_shape(), "dp", 8)[0]


def test_rule_tables_equal_the_reference():
    assert tshd.COL == jshd.COL and tshd.ROW == jshd.ROW
    assert tshd.EXPERT == jshd.EXPERT


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_production_mesh_shape(mesh_name):
    multi, _ = MESHES[mesh_name]
    mesh = tmesh.production_mesh_shape(multi)
    # the JAX function builds a device mesh, which this one-device process
    # cannot hold: compare with its shape and axes as it states them
    assert mesh == ({"pod": 2, "data": 16, "model": 16} if multi
                    else {"data": 16, "model": 16})
    for layout in ("dp", "fsdp"):
        assert tmesh.worker_axes_for(layout, multi) == \
            jmesh.worker_axes_for(layout, multi)
    over = "2,32,8" if multi else "64,4"
    assert list(tmesh.production_mesh_shape(multi, over).values()) == \
        [int(x) for x in over.split(",")]
    with pytest.raises(AssertionError):
        tmesh.production_mesh_shape(multi, "8,8")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    """Every arch at full width, both layouts, both production meshes:
    the same spec on every leaf, the same leaves."""
    jp, tp = _ref_params(arch), _port_params(arch)
    assert _port_leaves(tp) == _ref_leaves(jp)
    for mesh_name, (multi, _) in MESHES.items():
        mesh = tmesh.production_mesh_shape(multi)
        for layout in ("dp", "fsdp"):
            ref = _ref_by_path(jp, jshd.param_specs(jp, None, layout,
                                                    _fake(mesh)))
            got = _port_by_path(tshd.param_specs(tp, None, layout, mesh))
            assert got == ref, (arch, mesh_name, layout)
            # and without a mesh (the unsanitized rules)
            ref = _ref_by_path(jp, jshd.param_specs(jp, None, layout))
            assert _port_by_path(tshd.param_specs(tp, None, layout)) == ref


@pytest.mark.parametrize("spec,shape", [
    (("model", None), (51865, 384)), (("model", None), (256000, 384)),
    ((("data", "model"),), (512,)), ((("data", "model"),), (128,)),
    ((None, "model"), (3, 48))])
def test_sanitize_spec_and_local_shape(spec, shape):
    mesh = {"data": 16, "model": 16}
    got = tshd.sanitize_spec(spec, shape, mesh)
    assert got == _norm(jshd.sanitize_spec(P(*spec), shape, _fake(mesh)))
    local = tshd.local_shape(shape, got, mesh)
    n = [1 if e is None else 16 ** len(e if isinstance(e, tuple) else (e,))
         for e in got]
    assert local == tuple(d // k for d, k in zip(shape, n))
    if got != spec:
        with pytest.raises(ValueError):
            tshd.local_shape(shape, spec, mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_equals_the_reference(mesh_name):
    mesh = tmesh.production_mesh_shape(MESHES[mesh_name][0])
    for name in SHAPE_NAMES:
        B = jcfgs.SHAPES[name].global_batch
        assert tshd.batch_spec(mesh, B) == _norm(
            jshd.batch_spec(_fake(mesh), B)), name
    assert tshd.batch_axes(mesh) == jshd.batch_axes(_fake(mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch):
    """decode_32k caches under both kv layouts on both meshes; the port's
    meta caches have the reference's shapes and dtypes."""
    shape = jcfgs.SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    b = jbuild(jcfgs.get(arch))
    jc = jax.eval_shape(lambda: b.init_cache(B, S))
    for mesh_name, (multi, _) in MESHES.items():
        mesh = tmesh.production_mesh_shape(multi)
        for kv in ("hd_model", "seq_model"):
            tokens, tc, specs = tspecs.decode_input_specs(
                tcfgs.get(arch), tcfgs.SHAPES["decode_32k"], mesh, kv)
            ref = _ref_by_path(jc, jshd.cache_specs(jc, _fake(mesh), B, kv))
            assert _port_by_path(specs) == ref, (arch, mesh_name, kv)
            assert tuple(tokens.shape) == (B, 1)
    assert _port_leaves(tc) == _ref_leaves(jc)
    # "pos" stays on the host, as the port keeps it; the rest is meta
    assert all(x.device.type == "meta" for k, x in _tensors_by_path(tc)
               if not k.endswith("['pos']"))


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-tiny",
                                  "qwen3-moe-30b-a3b", "mamba2-1.3b"])
def test_batch_and_prefill_stand_ins(arch):
    """Train batches and prefill inputs: the reference's shapes and dtypes
    (the JAX stand-ins on a one-device mesh: shapes do not depend on it)
    and its batch spec on the production mesh."""
    jmesh1 = jcompat.make_mesh((1, 1), ("data", "model"))
    mesh = tmesh.production_mesh_shape(False)
    jcfg, tcfg = jcfgs.get(arch), tcfgs.get(arch)
    for name in ("train_4k", "prefill_32k"):
        jshape, tshape = jcfgs.SHAPES[name], tcfgs.SHAPES[name]
        bspec = tshd.batch_spec(mesh, tshape.global_batch)
        if tshape.kind == "train":
            ref = jspecs.train_batch_specs(jcfg, jshape, jmesh1)
            got, specs = tspecs.train_batch_specs(tcfg, tshape, mesh)
            assert _port_leaves(got) == _ref_leaves(ref)
            assert set(specs.values()) == {bspec}
        else:
            ref = jspecs.prefill_input_specs(jcfg, jshape, jmesh1)
            (tok, enc), spec = tspecs.prefill_input_specs(tcfg, tshape, mesh)
            assert spec == bspec
            assert (tuple(tok.shape), str(tok.dtype)) == \
                (tuple(ref[0].shape), "torch." + str(ref[0].dtype))
            assert (enc is None) == (ref[1] is None)
            if enc is not None:
                assert tuple(enc.shape) == tuple(ref[1].shape)
                assert str(enc.dtype) == "torch." + str(ref[1].dtype)
        assert all(x.device.type == "meta" for x in
                   (got.values() if tshape.kind == "train" else [tok]))
