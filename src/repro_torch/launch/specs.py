"""Meta-device stand-ins for every (architecture x input shape)
(counterpart of `repro.launch.specs`).

The JAX package lowers its dry-run against `ShapeDtypeStruct`s with
shardings attached. The port traces eagerly, so its stand-ins are meta
tensors: the shapes and dtypes of the real ones, no storage on any
device. Each function also returns the spec tree (`parallel.sharding`)
of its stand-ins on `mesh`, an {axis: size} dict
(`launch.mesh.production_mesh_shape`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import build
from repro_torch.parallel import sharding as shd

META = torch.device("meta")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _enc_embeds(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.encdec.enc_seq, cfg.d_model),
                       dtype=_dtype(cfg), device=META)


def train_batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """({tokens, targets[, enc_embeds]} of the global batch, their
    specs)."""
    B, S = shape.global_batch, shape.seq_len
    bspec = shd.batch_spec(mesh, B)
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META),
             "targets": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.is_encdec:
        batch["enc_embeds"] = _enc_embeds(cfg, B)
    return batch, {k: bspec for k in batch}


def prefill_input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """((tokens, enc_embeds or None), the batch spec)."""
    B, S = shape.global_batch, shape.seq_len
    args = (torch.empty((B, S), dtype=torch.int32, device=META),
            _enc_embeds(cfg, B) if cfg.is_encdec else None)
    return args, shd.batch_spec(mesh, B)


def decode_input_specs(cfg: ModelConfig, shape: InputShape, mesh,
                       kv_layout: str = "hd_model", batch: int = 0):
    """(tokens (B, 1), caches of shape.seq_len, their cache specs): ONE
    new token against a KV/state cache. `batch` overrides the shape's
    global batch (a rank's rows); the specs are those of the global
    batch."""
    B = batch or shape.global_batch
    caches = build(cfg).init_cache(B, shape.seq_len, device=META)
    specs = shd.cache_specs(caches, mesh, shape.global_batch, kv_layout)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    return tokens, caches, specs


def abstract_params(cfg: ModelConfig, mesh, layout: str, max_seq: int):
    """(meta parameters, their specs under `layout` on `mesh`)."""
    params = build(cfg).init(device=META, max_seq=max_seq)
    return params, shd.param_specs(params, cfg, layout, mesh)
