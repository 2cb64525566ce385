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

`build(cfg, mesh=...)` with a `launch.mesh.ProcessMesh` whose model axis
is above 1 gives the field over a rank's shards: `init` makes the full
tree and keeps the rank's shard of each leaf under the JAX package's
rules (`parallel.sharding`, "dp" layout), `param_specs(cfg, mesh,
max_seq)` gives those rules sanitised for the mesh (`DQGAN`'s
`param_specs`), and `field_fn` runs the model under the mesh's
model group (`parallel.tensor`), returning the gradients of the rank's
shards. Every arch of the zoo trains so.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor as TP

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


def param_specs(cfg, mesh, max_seq: int = 0):
    """The spec tree of `cfg`'s full parameters on `mesh` (the JAX
    package's "dp" rules, sanitised; traced on meta), or None when the
    mesh has no model axis above 1."""
    if mesh is None or mesh.model == 1:
        return None
    full = _build(cfg).init(generator=None, device="meta", max_seq=max_seq)
    return shd.param_specs(full, cfg, "dp", mesh.shape)


def _sharded(bundle: ModelBundle, mesh) -> ModelBundle:
    """`bundle` over the rank's shards of `mesh`'s model axis."""
    group = TP.model_group_for(mesh)
    cfg = bundle.cfg

    def init(generator=None, device=None, max_seq=0):
        full = bundle.init(generator=generator, device=device,
                           max_seq=max_seq)
        return shd.shard_tree(
            full, shd.param_specs(full, cfg, "dp", mesh.shape),
            mesh.model_index, mesh.model)

    field = bundle.field_fn

    def field_fn(params, batch, z=None, generator=None):
        with TP.model_parallel(group):
            return field(params, batch, z=z, generator=generator)

    if hasattr(field, "draw_z"):
        field_fn.draw_z = field.draw_z
    return ModelBundle(cfg=cfg, init=init, field_fn=field_fn,
                       loss_fn=None, prefill=None, decode_step=None,
                       init_cache=None)


def build(cfg, mesh=None) -> ModelBundle:
    """The bundle of `cfg`; over the shards of `mesh`'s model axis when it
    has one above 1 (training only: no serving entry points)."""
    bundle = _build(cfg)
    if mesh is not None and mesh.model > 1:
        return _sharded(bundle, mesh)
    return bundle


def _build(cfg) -> ModelBundle:
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
