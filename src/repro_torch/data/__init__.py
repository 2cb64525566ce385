"""Synthetic data of the port (counterpart of `repro.data`)."""
from .synthetic import (  # noqa: F401
    gaussian_mixture_sampler,
    procedural_images,
    render_blobs,
)
