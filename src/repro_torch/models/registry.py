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
is above 1, or whose layout is "fsdp", gives the bundle over a rank's
shards: `init` makes the full tree and keeps the rank's shard of each
leaf under the JAX package's rules for the mesh's layout
(`parallel.sharding`: "dp" over 'model', "fsdp" over 'data' and
'model'), `param_specs(cfg, mesh, max_seq)` gives those rules sanitised
for the mesh (`DQGAN`'s `param_specs`), and `field_fn` runs the model
under the mesh's model group (`parallel.tensor`) and, under fsdp, its
fsdp group (`parallel.fsdp`: each period's parameters gathered over the
data ranks at use, the loss the rank's share of its worker's), returning
the gradients of the rank's shards (under fsdp, of its worker's loss). Every arch of the zoo trains so, and an LM serves so:
`prefill(params, tokens, enc=None, max_len=0, kv_layout="hd_model")` and
`decode_step(params, tokens, caches)` run under the model group against
the rank's part of the decode cache, and `init_cache(batch, seq, dtype,
device, kv_layout="hd_model")` makes that part (`cache_specs(cfg, mesh,
batch, seq, kv_layout)` lays it out, `parallel.sharding.gather_cache`
puts the reference's cache back together). Their logits are the whole
(B, V). `decode_paged` refuses: the paged engine (`serve`) is one
process, in the reference too.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.parallel import fsdp as FS
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


def _sharded_mesh(mesh) -> bool:
    """True when a rank of `mesh` holds shards: a model axis above 1, or
    the fsdp layout."""
    return mesh is not None and (mesh.model > 1
                                 or getattr(mesh, "fsdp", False))


def _layout(mesh) -> str:
    return "fsdp" if getattr(mesh, "fsdp", False) else "dp"


def param_specs(cfg, mesh, max_seq: int = 0):
    """The spec tree of `cfg`'s full parameters on `mesh` (the JAX
    package's rules for the mesh's layout, "dp" or "fsdp", sanitised;
    traced on meta), or None when a rank of the mesh holds whole
    parameters."""
    if not _sharded_mesh(mesh):
        return None
    full = _build(cfg).init(generator=None, device="meta", max_seq=max_seq)
    return shd.param_specs(full, cfg, _layout(mesh), mesh.shape)


def cache_specs(cfg, mesh, batch: int, seq: int,
                kv_layout: str = "hd_model"):
    """The spec tree, over `mesh`'s model axis alone, of the decode cache
    `init_cache(cfg, batch, seq)` makes (the JAX package's `cache_specs`;
    traced on meta). A prefill's cache takes the same specs at its
    length: the prompt's, or max_len where longer."""
    full = lm.init_cache(cfg, batch, seq, device="meta")
    return shd.cache_specs(full, {"model": mesh.model}, batch, kv_layout)


def _decode_paged_refused(*args, **kwargs):
    raise ValueError("decode_paged: no paged decode over a model axis; the "
                     "paged engine is one process, as in the JAX package "
                     "(its serve/engine.py takes no mesh)")


def _sharded(bundle: ModelBundle, mesh) -> ModelBundle:
    """`bundle` over the rank's shards of `mesh` (its model axis, and its
    data axis under the fsdp layout)."""
    group = TP.model_group_for(mesh)
    fgroup = FS.fsdp_group_for(mesh)
    cfg = bundle.cfg
    layout = _layout(mesh)
    if fgroup is not None and bundle.prefill is None:
        raise ValueError(
            f"{cfg.name}: the fsdp layout takes the LM archs; the JAX "
            f"package picks it above 10 B parameters only, and no GAN of "
            f"the zoo is near that")
    # the full parameters' specs, for the fsdp gathers: made here, not in
    # a traced call (a learned position table's length changes no spec)
    specs = None if fgroup is None else param_specs(cfg, mesh, 1)

    def init(generator=None, device=None, max_seq=0):
        full = bundle.init(generator=generator, device=device,
                           max_seq=max_seq)
        return shd.shard_tree(
            full, shd.param_specs(full, cfg, layout, mesh.shape),
            **shd.rank_cut(mesh))

    @contextlib.contextmanager
    def parallel():
        with TP.model_parallel(group), FS.fsdp_parallel(fgroup, specs):
            yield

    field = bundle.field_fn

    def field_fn(params, batch, z=None, generator=None):
        with parallel():
            return field(params, batch, z=z, generator=generator)

    if hasattr(field, "draw_z"):
        field_fn.draw_z = field.draw_z
    if bundle.prefill is None:      # a GAN: no serving entry points
        return ModelBundle(cfg=cfg, init=init, field_fn=field_fn,
                           loss_fn=None, prefill=None, decode_step=None,
                           init_cache=None)

    def prefill(params, tokens, enc=None, max_len=0, kv_layout="hd_model"):
        with parallel():
            return lm.prefill(params, cfg, tokens, enc, max_len=max_len,
                              kv_layout=kv_layout)

    def decode_step(params, tokens, caches):
        with parallel():
            return lm.decode_step(params, cfg, tokens, caches)

    def init_cache(batch, seq, dtype=None, device=None,
                   kv_layout="hd_model"):
        """The rank's part of `init_cache(batch, seq)`: each leaf made at
        its local shape ("pos" on the CPU, as ever)."""
        part = shd.shard_cache(
            lm.init_cache(cfg, batch, seq, dtype, device="meta"),
            cache_specs(cfg, mesh, batch, seq, kv_layout),
            mesh.model_index, mesh.model)
        return T.tree_map(
            lambda x: x if x is None or x.device.type != "meta" else
            torch.zeros(x.shape, dtype=x.dtype, device=device), part)

    return ModelBundle(cfg=cfg, init=init, field_fn=field_fn,
                       loss_fn=None, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
                       decode_paged=_decode_paged_refused)


def build(cfg, mesh=None) -> ModelBundle:
    """The bundle of `cfg`; over a rank's shards of `mesh` when it has a
    model axis above 1 or the fsdp layout."""
    bundle = _build(cfg)
    if _sharded_mesh(mesh):
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
