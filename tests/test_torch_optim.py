"""Port parity: `repro_torch.optim` against `repro.optim`: sgd, adam and
oadam over 5 steps on the same random trees (numpy-seeded parameters and
gradients, a bf16 leaf among them), and `cosine_lr` at every step of a
schedule, rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro_torch import optim as TO
from repro_torch import tree as T
from torch_ranks import one_thread  # noqa: F401 (autouse)

SHAPES = {"gen": {"w": (7, 5), "b": (5,)}, "disc": {"w": (5, 3)}}


def _tree(rs):
    return T.tree_map(lambda s: rs.randn(*s).astype(np.float32), SHAPES)


def _to_jax(tree):
    return T.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return T.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("name", sorted(TO.REGISTRY))
def test_five_steps_match(name):
    rs = np.random.RandomState(0)
    params = _tree(rs)
    grads = [_tree(rs) for _ in range(5)]
    jopt, topt = JO.REGISTRY[name](1e-2), TO.REGISTRY[name](1e-2)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(_to_jax(g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    for a, b in zip(T.leaves(jax.device_get(jp)), T.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    if name != "sgd":
        assert int(ts["t"]) == int(js["t"]) == 5
        keys = ("m", "v", "prev") if name == "oadam" else ("m", "v")
        for k in keys:
            for a, b in zip(T.leaves(jax.device_get(js[k])),
                            T.leaves(ts[k])):
                assert b.dtype == torch.float32
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["adam", "oadam"])
def test_moments_are_float32_for_bf16_params(name):
    params = {"w": torch.ones((4, 3), dtype=torch.bfloat16)}
    opt = TO.REGISTRY[name](1e-2)
    st = opt.init(params)
    new, st = opt.update({"w": torch.full((4, 3), 0.5,
                                          dtype=torch.bfloat16)}, st, params)
    assert new["w"].dtype == torch.bfloat16
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    jst = JO.REGISTRY[name](1e-2).init({"w": jnp.ones((4, 3), jnp.bfloat16)})
    assert jst["m"]["w"].dtype == jnp.float32


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 20), (5, 5)])
def test_cosine_lr_at_every_step(warmup, total):
    js, ts = JO.cosine_lr(0.1, warmup, total), TO.cosine_lr(0.1, warmup,
                                                            total)
    for s in range(total + 1):
        np.testing.assert_allclose(float(ts(s)), float(js(s)), rtol=1e-6,
                                   atol=1e-12)
