"""Port parity: `repro_torch.gan_common` (the paper's mixture harness)
against `benchmarks/gan_common.py`: the Fréchet distance on the same
features, `eval_mixture_gan` on the JAX harness's own latent draw, real
samples and projection weights (modes and hq_frac exact, fid to rtol
1e-5), each method's strategy and optimizer pairing, and a short
`train_mixture_gan` run of each method on the CPU."""
import math

import jax
import numpy as np
import pytest
import torch

from benchmarks import gan_common as JGC
from repro.data import gaussian_mixture_sampler as j_sampler
from repro.models import gan as JG
from repro_torch import gan_common as TGC
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import gaussian_mixture_sampler as t_sampler
from torch_ranks import one_thread  # noqa: F401 (autouse)


def test_frechet_distance_same_on_the_same_features():
    rs = np.random.RandomState(0)
    a, b = rs.randn(500, 64), rs.randn(400, 64) * 1.3 + 0.2
    assert TGC.frechet_distance(a, b) == JGC.frechet_distance(a, b)
    assert TGC.frechet_distance(a, a) == JGC.frechet_distance(a, a) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_mixture_gan_on_the_jax_draws(seed):
    cfg = JG.GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                       hidden=128, weight_clip=0.1)
    params = JG.mlp_gan_init(jax.random.key(seed), cfg)
    sample_real, centers = j_sampler(n_modes=8)
    key, n = jax.random.key(50 + seed), 2000
    want = JGC.eval_mixture_gan(params, cfg, sample_real, centers, key, n)
    # the JAX harness's draws, as it makes them
    z = jax.random.normal(key, (n, cfg.latent_dim))
    real = sample_real(jax.random.fold_in(key, 1), n)
    fk = jax.random.key(123)
    w1 = jax.random.normal(fk, (2, 128)) / np.sqrt(2)
    w2 = jax.random.normal(jax.random.fold_in(fk, 1), (128, 64)) \
        / np.sqrt(128)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tcfg = TGC.mixture_config()
    _, tcenters = t_sampler(n_modes=8)
    tparams = params_from_jax(jax.device_get(params))
    got = TGC.eval_mixture_gan(tparams, tcfg, None, tcenters, z=t(z),
                               real=t(real), proj=(t(w1), t(w2)))
    assert got["modes"] == want["modes"]
    assert got["hq_frac"] == want["hq_frac"]
    # the rounded fid to its last digit; unrounded to rtol 1e-5
    assert abs(got["fid"] - want["fid"]) <= 1.0001e-4
    from repro.models.gan import mlp_generate
    jfake = mlp_generate(params["gen"], cfg, z)
    jfid = JGC.frechet_distance(JGC.random_features(fk, jfake),
                                JGC.random_features(fk, real))
    tfake = TGC.mlp_generate(tparams["gen"], tcfg, t(z))
    tfid = TGC.frechet_distance(
        TGC.random_features(tfake, (t(w1), t(w2))),
        TGC.random_features(t(real), (t(w1), t(w2))))
    np.testing.assert_allclose(tfid, jfid, rtol=1e-5)


@pytest.mark.parametrize("method", sorted(JGC.METHODS))
def test_method_strategies_and_pairings_match(method):
    js, ts = JGC.METHOD_STRATEGIES[method], TGC.METHOD_STRATEGIES[method]
    assert ts.to_json() == js.to_json()
    assert ts.short_hash() == js.short_hash()
    assert TGC.METHODS[method] == JGC.METHODS[method]
    assert TGC.METHOD_LR[method] == JGC.METHOD_LR[method]
    cfg = TGC.mixture_config()
    jtr = JGC.make_trainer(method, JG.GANConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}), 1e-3,
        strategy_overrides={"schedule": "delayed", "staleness_tau": 2})
    ttr = TGC.make_trainer(method, cfg, 1e-3, strategy_overrides={
        "schedule": "delayed", "staleness_tau": 2}, device="cpu")
    assert ttr.strategy.short_hash() == jtr.strategy.short_hash()
    assert ttr.dq.lr_mults == jtr.dq.lr_mults


@pytest.mark.parametrize("method", ["CPOAdam", "CPOAdam-GQ", "DQGAN"])
def test_train_mixture_gan_runs_each_method(method):
    final, curve, st = TGC.train_mixture_gan(
        method, steps=8, batch=32, eval_every=4, device="cpu",
        strategy_overrides={"schedule": "local_k", "local_k": 2})
    assert [m["step"] for m in curve] == [4, 8]
    assert 0 <= final["modes"] <= 8 and 0.0 <= final["hq_frac"] <= 1.0
    assert math.isfinite(final["fid"]) and st.step == 8
    # the critic's weights stay clipped (WGAN), in float32
    c = torch.tensor(TGC.mixture_config().weight_clip)
    assert all(bool(x.abs().max() <= c) for x in T.leaves(st.params["disc"]))
