"""repro_torch — the DQGAN reproduction ported to PyTorch and CUDA.

Beside the JAX package `repro`, which stays the reference, and mirroring
its module layout: `core` (compressors, error feedback, exchange plans,
the DQGAN trainer), `comm` (buckets, planner, ledger), `strategy`,
`configs`, `models`, `data`, `serve` (the continuous-batching engine over
a paged KV cache), `kernels` (hand-written CUDA kernels beside their
plain PyTorch versions), `launch.train` and `launch.serve`. It imports
torch and numpy only, never jax and nothing of `repro`.
"""
