"""Synthetic data of the port (counterpart of `repro.data`)."""
from .synthetic import (  # noqa: F401
    enc_embeds,
    gaussian_mixture_sampler,
    lm_batch_iterator,
    lm_tokens,
    procedural_images,
    render_blobs,
    synthetic_lm_batch,
)
