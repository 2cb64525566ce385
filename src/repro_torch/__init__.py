"""repro_torch — the DQGAN reproduction ported to PyTorch and CUDA.

Beside the JAX package `repro`, which stays the reference, and mirroring
its module layout: `core` (compressors, error feedback, exchange plans,
the DQGAN trainer), `comm` (buckets, planner, ledger), `strategy`,
`configs`, `models`, `data`, `kernels` (hand-written CUDA kernels beside
their plain PyTorch versions) and `launch.train`. It imports torch and
numpy only, never jax and nothing of `repro`.
"""
