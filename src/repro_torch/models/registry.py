"""Model registry (counterpart of `repro.models.registry`): bind a
`ModelConfig` or `GANConfig` to one functional bundle, which the trainer
and the tests use.

    build(cfg) -> ModelBundle(cfg, init, field_fn, loss_fn, prefill,
                              decode_step, init_cache, decode_paged)

`field_fn(params, batch, z=None, generator=None) -> (grads, metrics)` is
what `core.dqgan.DQGAN` takes: for a GAN the WGAN field of
`gan.gan_field_fn`, with its `draw_z`; for an LM the gradient of
`model.loss_fn`'s total (cross-entropy plus the MoE aux losses), in the
parameters' dtypes, with the metrics {"loss", **aux}. An LM field draws
nothing, so it has no `draw_z`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T

from . import gan as gan_lib
from . import model as lm


@dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    init: Callable                  # (generator=, device=, max_seq=) -> params
    field_fn: Callable              # (params, batch, z, generator) -> (grads, metrics)
    loss_fn: Optional[Callable]     # (params, batch) -> (total, metrics)
    prefill: Optional[Callable]     # (params, tokens[, enc, max_len]) -> (logits, caches)
    decode_step: Optional[Callable]
    init_cache: Optional[Callable]
    # (params, tokens (B, 1), paged_caches, lengths (B,)) -> (logits,
    # caches): the serving engine's per-row-position decode (None for GANs)
    decode_paged: Optional[Callable] = None


def lm_field_fn(cfg):
    """field_fn(params, batch, z=None, generator=None) -> (grads, metrics)
    of an LM: autograd of `model.loss_fn`'s total at `params`."""

    def field_fn(params, batch, z=None, generator=None):
        del z, generator
        paths, leaves = T.flatten(params)
        leaves = [w.detach().requires_grad_() for w in leaves]
        with torch.enable_grad():
            total, metrics = lm.loss_fn(T.unflatten(paths, leaves), cfg,
                                        batch)
            # a leaf the loss does not reach gets zeros, as in JAX
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (T.unflatten(paths, [g.to(w.dtype)
                                    for g, w in zip(grads, leaves)]),
                {k: v.detach() for k, v in metrics.items()})

    return field_fn


def build(cfg) -> ModelBundle:
    if isinstance(cfg, gan_lib.GANConfig):
        return ModelBundle(
            cfg=cfg,
            init=lambda generator=None, device=None, max_seq=0: gan_lib.init(
                cfg, generator=generator, device=device),
            field_fn=gan_lib.gan_field_fn(cfg),
            loss_fn=None,
            prefill=None,
            decode_step=None,
            init_cache=None,
        )
    return ModelBundle(
        cfg=cfg,
        init=lambda generator=None, device=None, max_seq=0: lm.init(
            cfg, generator=generator, device=device, max_seq=max_seq),
        field_fn=lm_field_fn(cfg),
        loss_fn=lambda params, batch: lm.loss_fn(params, cfg, batch),
        prefill=lambda params, tokens, enc=None, max_len=0: lm.prefill(
            params, cfg, tokens, enc, max_len=max_len),
        decode_step=lambda params, tokens, caches: lm.decode_step(
            params, cfg, tokens, caches),
        init_cache=lambda batch, seq, dtype=None, device=None: lm.init_cache(
            cfg, batch, seq, dtype, device),
        decode_paged=lambda params, tokens, caches, lengths:
            lm.decode_step_paged(params, cfg, tokens, caches, lengths),
    )
