"""Synthetic data on a torch generator (counterpart of
`repro.data.synthetic`): LM token streams, the 2-D Gaussian mixture and
procedural images.

The two frameworks' generators never give the same numbers, so each
sampler keeps its arithmetic in a function of explicit draws
(`lm_tokens`, `render_blobs`, the `idx`/`noise` of a mixture sample): the
tests feed both packages the same draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# LM tokens
# --------------------------------------------------------------------------- #
LM_OFFSETS = (1, 7, 13, 29)   # the preferred successor offsets


def lm_tokens(start, chose, vocab):
    """The token stream of `synthetic_lm_batch` on explicit draws: start
    (B, 1) in [0, vocab), chose (B, S) in [0, len(LM_OFFSETS)). t_{i+1} =
    (t_i + offset[chose_i]) mod vocab, the cumsum in int64. Returns
    {"tokens", "targets"} (B, S) int64, targets the tokens shifted by
    one."""
    offsets = torch.tensor(LM_OFFSETS, dtype=torch.int64,
                           device=chose.device)
    start = start.long()
    toks = (start + torch.cumsum(offsets[chose.long()], dim=1)) % vocab
    return {"tokens": torch.cat([start, toks[:, :-1]], dim=1),
            "targets": toks}


def synthetic_lm_batch(batch, seq, vocab, *, generator=None, device=None):
    """A correlated token batch: each next token a few preferred offsets
    past the current one, learnable by a small LM."""
    start = torch.randint(0, vocab, (batch, 1), generator=generator,
                          device=device)
    chose = torch.randint(0, len(LM_OFFSETS), (batch, seq),
                          generator=generator, device=device)
    return lm_tokens(start, chose, vocab)


def enc_embeds(normal):
    """The encoder inputs of an encoder-decoder batch on explicit standard
    normal draws (batch,) + enc_shape: 0.1 · N(0, 1), float32."""
    return 0.1 * normal.float()


def lm_batch_iterator(batch, seq, vocab, *, generator=None, device=None,
                      enc_shape=None):
    """Endless `synthetic_lm_batch` batches drawn in turn from `generator`
    (the JAX package folds a batch index into a seed's key instead); with
    `enc_shape` (enc_seq, d_model) each batch also holds "enc_embeds",
    drawn after its tokens."""
    while True:
        b = synthetic_lm_batch(batch, seq, vocab, generator=generator,
                               device=device)
        if enc_shape is not None:
            b["enc_embeds"] = enc_embeds(torch.randn(
                (batch,) + tuple(enc_shape), generator=generator,
                device=device))
        yield b


# --------------------------------------------------------------------------- #
# 2-D Gaussian mixture (GAN synthetic benchmark)
# --------------------------------------------------------------------------- #
def gaussian_mixture_sampler(n_modes=8, radius=2.0, std=0.05, device=None):
    angles = np.linspace(0, 2 * math.pi, n_modes, endpoint=False)
    centers = torch.tensor(
        np.stack([radius * np.cos(angles), radius * np.sin(angles)], -1),
        dtype=torch.float32, device=device)

    def sample(n, generator=None, idx=None, noise=None):
        if idx is None:
            idx = torch.randint(0, n_modes, (n,), generator=generator,
                                device=centers.device)
        if noise is None:
            noise = torch.randn((n, 2), generator=generator,
                                device=centers.device)
        return centers[idx] + std * noise

    return sample, centers


# --------------------------------------------------------------------------- #
# procedural images (CIFAR stand-in)
# --------------------------------------------------------------------------- #
def render_blobs(cx, cy, sig, hue, size):
    """Images (n, size, size, C) of a Gaussian blob at (cx, cy) of width
    sig with a color gradient from hue; inputs (n,1,1,1) and (n,1,1,C)."""
    channels = hue.shape[-1]
    lin = torch.linspace(0, 1, size, device=cx.device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    grid_x = xx[None, :, :, None]
    grid_y = yy[None, :, :, None]
    blob = torch.exp(-((grid_x - cx) ** 2 + (grid_y - cy) ** 2)
                     / (2 * sig**2))
    phase = 2 * math.pi * (hue + torch.arange(channels, device=cx.device)
                           / channels)
    color = 0.5 + 0.5 * torch.sin(phase)
    img = blob * color + 0.1 * (grid_x + grid_y) - 0.5
    return torch.clamp(2 * img, -1, 1)


def procedural_images(n, size=32, channels=3, *, generator=None,
                      device=None):
    """Randomly placed, oriented and colored blobs, values in [-1, 1],
    NHWC: a structured stand-in for CIFAR10."""
    def u(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=device) \
            * (hi - lo) + lo

    cx = u((n, 1, 1, 1), 0.25, 0.75)
    cy = u((n, 1, 1, 1), 0.25, 0.75)
    sig = u((n, 1, 1, 1), 0.05, 0.15)
    hue = u((n, 1, 1, channels), 0.0, 1.0)
    return render_blobs(cx, cy, sig, hue, size)
