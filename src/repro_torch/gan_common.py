"""The paper's experimental comparison (§4) in the port (counterpart of
`benchmarks/gan_common.py`): DQGAN vs CPOAdam vs CPOAdam-GQ on a 2-D
Gaussian mixture, scored by

  * mode coverage and the high-quality-sample fraction, and
  * a "synthetic FID": the Fréchet distance between real and fake
    feature statistics in a fixed random projection feature space (the
    offline stand-in for Inception features).

The JAX harness draws from `jax.random` keys, which torch cannot
reproduce: here the draws come from torch generators seeded from `seed`,
and `eval_mixture_gan` also takes the latent draw, the real samples and
the projection weights, so that a test can hand it the JAX harness's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import DQConfig
from repro_torch.core.dqgan import DQGAN
from repro_torch.data import gaussian_mixture_sampler
from repro_torch.models.gan import (GANConfig, clip_disc, gan_field_fn,
                                    mlp_gan_init, mlp_generate)
from repro_torch.strategy import Compression, ExchangePlan, Strategy

# Per-method distribution strategy (one worker: no worker axes) and
# optimizer/message pairing. The paper's baselines are points in the
# strategy lattice; anything schedule- or participation-shaped is layered
# on via `strategy_overrides`.
_SINGLE = ExchangePlan(kind="sim", worker_axes=())
METHOD_STRATEGIES = {
    "CPOAdam": Strategy(compression=Compression(compressor="identity",
                                                error_feedback=False),
                        exchange=_SINGLE),
    "CPOAdam-GQ": Strategy(compression=Compression(error_feedback=False),
                           exchange=_SINGLE),
    "DQGAN": Strategy(exchange=_SINGLE),
    "DQGAN-noEF": Strategy(compression=Compression(error_feedback=False),
                           exchange=_SINGLE),
}
METHODS = {
    # name: (optimizer, message)
    "CPOAdam": ("oadam", "grad"),
    "CPOAdam-GQ": ("oadam", "grad"),
    "DQGAN": ("omd", "update"),
    "DQGAN-noEF": ("omd", "update"),
}

# per-method default learning rates ("chosen by an inspection of grid
# search results", paper §4): the Adam family needs a smaller step than
# plain OMD here.
METHOD_LR = {"CPOAdam": 1e-3, "CPOAdam-GQ": 1e-3, "DQGAN": 3e-3,
             "DQGAN-noEF": 3e-3}

# the fixed seed of the feature projection, as the JAX harness's key(123)
FEATURE_SEED = 123


def mixture_config() -> GANConfig:
    """The harness's MLP GAN on the 2-D mixture."""
    return GANConfig(name="mix", image_size=0, data_dim=2, latent_dim=16,
                     hidden=128, weight_clip=0.1)


def make_trainer(method: str, cfg: GANConfig, lr: float,
                 dq_overrides: dict | None = None,
                 strategy_overrides: dict | None = None,
                 workers: int = 1, device="cuda", seed: int = 0) -> DQGAN:
    """The method's trainer; `workers` > 1 stacks that many workers on the
    device (the JAX harness's mesh of M machines)."""
    opt, msg = METHODS[method]
    strat = METHOD_STRATEGIES[method]
    if strategy_overrides:
        strat = strat.evolve(**strategy_overrides)
    if workers > 1 and not strat.exchange.worker_axes:
        strat = strat.evolve(worker_axes=("data",))
    # Adam preconditioning normalizes the field-level critic boost away;
    # restore the n_critic=5 ratio after it (TTUR).
    mults = (("disc", cfg.disc_grad_mult),) if opt in ("adam", "oadam") else ()
    dq = DQConfig.from_strategy(strat, optimizer=opt, message=msg, lr=lr,
                                lr_mults=mults)
    if dq_overrides:
        dq = dataclasses.replace(dq, **dq_overrides)
    return DQGAN(field_fn=gan_field_fn(cfg), dq=dq, device=device,
                 seed=seed, workers=workers)


def frechet_distance(feats_a, feats_b):
    """Fréchet distance between Gaussians fit to two feature sets, with a
    diagonal-covariance approximation (stable without scipy sqrtm)."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    va, vb = feats_a.var(0), feats_b.var(0)
    return float(np.sum((mu_a - mu_b) ** 2)
                 + np.sum(va + vb - 2 * np.sqrt(np.maximum(va * vb, 0))))


def feature_weights(d: int, dim: int = 64, device=None):
    """(w1 (d, 128), w2 (128, dim)): the fixed random 2-layer projection,
    from a generator seeded with FEATURE_SEED."""
    gen = torch.Generator(device=device).manual_seed(FEATURE_SEED)
    w1 = torch.randn((d, 128), generator=gen, device=device) / math.sqrt(d)
    w2 = torch.randn((128, dim), generator=gen, device=device) \
        / math.sqrt(128)
    return w1, w2


def random_features(x, weights) -> np.ndarray:
    """The stand-in feature extractor: tanh(tanh(x w1) w2), as numpy."""
    w1, w2 = weights
    return torch.tanh(torch.tanh(x @ w1) @ w2).cpu().numpy()


def eval_mixture_gan(params, cfg, sample_real, centers, generator=None,
                     n=2000, z=None, real=None, proj=None):
    """Modes covered (more than 1 % of n fakes nearest to a center), the
    fraction within 0.25 of a center (5σ), and the synthetic FID. `z`,
    `real` and `proj` (the projection's (w1, w2)) default to draws from
    `generator` and to `feature_weights`."""
    dev = centers.device
    if z is None:
        z = torch.randn((n, cfg.latent_dim), generator=generator, device=dev)
    if real is None:
        real = sample_real(n, generator=generator)
    if proj is None:
        proj = feature_weights(real.shape[-1], device=dev)
    n = z.shape[0]
    fake = mlp_generate(params["gen"], cfg, z)
    d = torch.linalg.norm(fake[:, None] - centers[None], dim=-1)
    nearest, assign = d.min(dim=1)
    covered = int((np.bincount(assign.cpu().numpy(), minlength=len(centers))
                   > n * 0.01).sum())
    hq = float((nearest < 0.25).float().mean())
    fid = frechet_distance(random_features(fake, proj),
                           random_features(real, proj))
    return {"modes": covered, "hq_frac": round(hq, 3),
            "fid": round(fid, 4)}


@torch.no_grad()
def train_mixture_gan(method: str, steps=1500, batch=256, lr=None, seed=0,
                      eval_every=0, dq_overrides: dict | None = None,
                      strategy_overrides: dict | None = None,
                      workers: int = 1, device="cuda"):
    """Train the 2-D mixture GAN; `strategy_overrides` patches the
    method's distribution strategy by legacy field name (e.g.
    {"schedule": "delayed", "staleness_tau": 4}); `dq_overrides` patches
    optimizer-side DQConfig fields; `workers` stacks that many workers.
    Returns (final metrics, curve of metrics every `eval_every` steps,
    final state)."""
    lr = METHOD_LR.get(method, 1e-3) if lr is None else lr
    device = torch.device(device)
    cfg = mixture_config()
    sample_real, centers = gaussian_mixture_sampler(n_modes=8, device=device)
    init_gen = torch.Generator(device=device).manual_seed(seed)
    params = mlp_gan_init(cfg, generator=init_gen, device=device)
    tr = make_trainer(method, cfg, lr, dq_overrides, strategy_overrides,
                      workers=workers, device=device, seed=seed)
    st = tr.init(params)
    sched = tr.strategy.schedule.runtime()
    data_gen = torch.Generator(device=device).manual_seed(seed + 1)
    eval_gen = torch.Generator(device=device)
    curve = []
    for i in range(steps):
        out = tr.step(st, {"real": sample_real(batch, generator=data_gen)},
                      do_exchange=sched.is_exchange_step(i))
        st = out.state._replace(params=clip_disc(out.state.params, cfg))
        if eval_every and (i + 1) % eval_every == 0:
            eval_gen.manual_seed(10_000 + i)
            m = eval_mixture_gan(st.params, cfg, sample_real, centers,
                                 eval_gen)
            m["step"] = i + 1
            curve.append(m)
    eval_gen.manual_seed(999_999)
    final = eval_mixture_gan(st.params, cfg, sample_real, centers, eval_gen)
    return final, curve, st
