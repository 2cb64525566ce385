"""Deterministic per-worker heterogeneity.
(Counterpart of `repro.sched.straggler`: numpy only, copied, not
imported.)

A `StragglerProfile` describes how the paper's M machines deviate from
the homogeneous ideal: a persistent per-worker slowdown (lognormal —
some machines are simply slower), per-step multiplicative jitter (OS
noise), and rare transient spikes (GC pauses, preemptions). Everything
is seeded numpy on the host — the training step never sees it;
only the wall-clock model (`sched.clock`) consumes the sampled times.

`step_times(profile, M, steps, seed)` is the whole API surface the clock
needs: a (steps, M) matrix of per-step compute times in units of the
homogeneous per-worker step time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StragglerProfile:
    name: str
    # sigma of the persistent lognormal per-worker slowdown (0 = homogeneous)
    slowdown_sigma: float = 0.0
    # sigma of the per-step lognormal jitter
    jitter_sigma: float = 0.0
    # probability / magnitude of transient spikes (worker-step granularity)
    spike_prob: float = 0.0
    spike_factor: float = 1.0

    def describe(self) -> str:
        return (f"{self.name}(slowdown_sigma={self.slowdown_sigma}, "
                f"jitter_sigma={self.jitter_sigma}, "
                f"spikes={self.spike_prob}x{self.spike_factor})")


PROFILES = {
    "none": StragglerProfile("none"),
    # a realistic shared-cluster pod: ±15% persistent skew, small jitter,
    # 2% of worker-steps hit a 3x pause
    "mild": StragglerProfile("mild", slowdown_sigma=0.15, jitter_sigma=0.05,
                             spike_prob=0.02, spike_factor=3.0),
    # heterogeneous fleet (mixed generations): heavy persistent skew and
    # frequent long pauses — the regime where lockstep exchange collapses
    "heavy": StragglerProfile("heavy", slowdown_sigma=0.4, jitter_sigma=0.1,
                              spike_prob=0.05, spike_factor=6.0),
}


def get_profile(name: str) -> StragglerProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown straggler profile {name!r}; "
            f"choose from {sorted(PROFILES)}") from None


def worker_slowdowns(profile: StragglerProfile, M: int,
                     seed: int = 0) -> np.ndarray:
    """Persistent per-worker slowdown factors, median-normalized to keep
    the homogeneous compute budget comparable across profiles. Shape (M,)."""
    if profile.slowdown_sigma == 0.0:
        return np.ones(M)
    rs = np.random.RandomState(seed)
    s = np.exp(profile.slowdown_sigma * rs.randn(M))
    return s / np.median(s)


def step_times(profile: StragglerProfile, M: int, steps: int,
               seed: int = 0, base: float = 1.0) -> np.ndarray:
    """(steps, M) per-step per-worker compute times, fully determined by
    (profile, M, steps, seed). `base` is the homogeneous per-worker
    step time (seconds)."""
    rs = np.random.RandomState(seed + 1)
    t = np.full((steps, M), float(base))
    t *= worker_slowdowns(profile, M, seed)[None, :]
    if profile.jitter_sigma:
        t *= np.exp(profile.jitter_sigma * rs.randn(steps, M))
    if profile.spike_prob:
        spikes = rs.rand(steps, M) < profile.spike_prob
        t *= np.where(spikes, profile.spike_factor, 1.0)
    return t
