"""How many greedy tokens the port's bf16 engine shares with the JAX engine,
for three ways of writing the tanh GELU, reported and not checked:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/bf16_token_share.py

- each formula's share of 65,536 bf16 draws from N(0, 9) that differ from
  `jax.nn.gelu(approximate=True)`;
- gemma-2b `reduced()` in bf16, `tests/test_torch_serve.py`'s churn
  scenario at several weight and request seeds: the tokens of the port's
  engine (`gather` and `kernel`) equal to the JAX engine's, position by
  position.

The formulas: the port's (`models.layers._gelu_tanh`: op by op in the
activation's dtype, both constants rounded to it), the same with 0.044715
left a Python float (so k·x³ is taken in float32 before it rounds), and
`F.gelu(approximate="tanh")` (float32, one rounding). Under a minute on
a CPU.
"""
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_serve as S  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

SCENARIOS = [(0, 3), (1, 3), (2, 3), (0, 5), (0, 9), (3, 11)]  # (key, rng)


def _k_float32(v):
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=v.dtype)
    cube = (v * v) * v
    return v * (0.5 * (1.0 + torch.tanh(c * (v + 0.044715 * cube))))


FORMULAS = {"port": TL._gelu_tanh, "0.044715 in f32": _k_float32,
            "F.gelu": lambda v: F.gelu(v, approximate="tanh")}


def main():
    x = (3 * np.random.RandomState(0).randn(65536)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.nn.gelu(xj, approximate=True).astype(jnp.float32))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).bfloat16()
    for name, f in FORMULAS.items():
        n = int((f(xt).float().numpy() != want).sum())
        print(f"# gelu [{name}]: {n} of {x.size} bf16 outputs differ from "
              f"jax.nn.gelu")
    cfg = dataclasses.replace(S.JCFG, param_dtype="bfloat16")
    tcfg = dataclasses.replace(S.TCFG, param_dtype="bfloat16")
    totals = {(f, i): 0 for f in FORMULAS for i in ("gather", "kernel")}
    n_all = 0
    try:
        for key, seed in SCENARIOS:
            params = JM.init(jax.random.key(key), cfg, 0)
            reqs = S._requests(7, np.random.default_rng(seed),
                               cls=S.JRequest)
            ref = S._run_churn(S.JEngine(cfg, S.SCFG, params), reqs)
            tparams = params_from_jax(jax.device_get(params))
            n = sum(map(len, ref.values()))
            n_all += n
            row = []
            for (name, impl) in totals:
                TL._gelu_tanh = FORMULAS[name]
                out = S._run_churn(
                    Engine(tcfg, S.SCFG, tparams, attn_impl=impl),
                    S._requests(7, np.random.default_rng(seed)))
                same = sum(a == b for r in ref
                           for a, b in zip(out[r], ref[r]))
                totals[name, impl] += same
                row.append(f"{name}/{impl} {same}")
            TL._gelu_tanh = FORMULAS["port"]
            print(f"# weights key {key}, requests seed {seed} ({n} tokens): "
                  + ", ".join(row))
    finally:
        TL._gelu_tanh = FORMULAS["port"]
    print(f"# all {len(SCENARIOS)} scenarios ({n_all} tokens): "
          + ", ".join(f"{f}/{i} {t}" for (f, i), t in totals.items()))


if __name__ == "__main__":
    main()
