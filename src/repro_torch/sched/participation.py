"""Partial worker participation per exchange round (counterpart of
`repro.sched.participation`).

Each round the server averages a sampled subset of the M workers; the
rest fold their message into their error-feedback residual instead.
Sampling is count-exact: n = max(1, round(p·M)) participants a round, the
first n entries of a random permutation, so the rescale q̂ ← q̂·M/n is a
host constant while the mask itself stays on the device.

    participant     : p̂ = Q(m + e1),  e1 ← m + e1 − p̂
    non-participant : p̂ = 0,          e1 ← e1 + m
    server          : q̂ = (M/n)·(1/M) Σ_m p̂^m

JAX's permutation (threefry keys) cannot be reproduced in torch: the mask
here comes from a `torch.Generator` on the device, and the trainer's step
also accepts the mask as an injected draw (the parity tests replay the
JAX package's masks that way). The mask always covers all M workers:
with the workers spread over the ranks of a process group, every rank
draws it from the same shared stream, takes the count (and the adaptive
family's row) from the whole mask, and applies its own rows.
"""
from __future__ import annotations

import numpy as np
import torch


def n_participants(participation: float, n_workers: int) -> int:
    """Per-round participant count for rate `participation`."""
    if not 0.0 < participation <= 1.0:
        raise ValueError(f"participation must be in (0, 1], got "
                         f"{participation}")
    return max(1, int(round(participation * n_workers)))


def round_mask(generator: torch.Generator, n_workers: int,
               n_part: int) -> torch.Tensor:
    """(W,) float32 0/1 mask with exactly n_part ones, drawn on the
    generator's device (no host sync)."""
    perm = torch.randperm(n_workers, generator=generator,
                          device=generator.device)
    mask = torch.zeros((n_workers,), dtype=torch.float32,
                       device=generator.device)
    return mask.index_fill_(0, perm[:n_part], 1.0)


def round_count(mask_vec: torch.Tensor) -> torch.Tensor:
    """The round's participant count as a device tensor (int64, 0-d): the
    adaptive PlanFamily selects its levels row with it on the device."""
    return mask_vec.sum().to(torch.int64)


def host_round_participants(rng: np.random.RandomState, n_workers: int,
                            n_part: int) -> np.ndarray:
    """Host-side sampling for the wall-clock model (numpy; the clock only
    needs a count-exact sample, not the step's). Sorted participant
    indices."""
    return np.sort(rng.permutation(n_workers)[:n_part])
