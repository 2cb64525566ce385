"""Sequential (batch-1) generation, the engine's correctness oracle and
throughput baseline (counterpart of `repro.serve.baseline`).

Runs the same floor-bucket prefill + tail-decode schedule and the same
`sample_token` draw as the continuous-batching engine, over the model's
dense decode cache sized once to `ServeConfig.max_context`, the length
the paged decode's gathered view has. With ``compression=`` it quantizes
and dequantizes the weights as the engine does.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import model as lm

from .engine import _Weights, sample_token
from .kv_cache import (
    ServeConfig,
    check_model_servable,
    dense_cache_len,
    plan_request,
)


class SequentialGenerator:
    """One request at a time over a dense cache; same tokens as Engine."""

    def __init__(self, cfg, serve_cfg: ServeConfig, params, *,
                 compression=None, seed: int = 0):
        check_model_servable(cfg)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.device = params["embed"].device
        self.weights = _Weights(cfg, params, compression, seed)
        self._seed = seed
        self.steps = 0

    def _tokens(self, rows):
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def generate(self, prompt: List[int], max_new: int, *, rid: int = 0,
                 temperature: float = 0.0,
                 stop_token: Optional[int] = None) -> List[int]:
        bucket, _ = plan_request(len(prompt), max_new, self.scfg)
        out: List[int] = []

        if bucket > 0:
            logits, caches = lm.prefill(self.weights.params(), self.cfg,
                                        self._tokens([prompt[:bucket]]),
                                        max_len=dense_cache_len(self.scfg))
        else:
            logits = None
            caches = lm.init_cache(self.cfg, 1, dense_cache_len(self.scfg),
                                   device=self.device)
        to_feed = list(prompt[bucket:])

        last = 0
        if not to_feed:                      # bucket == len(prompt)
            tok = sample_token(logits[0], temperature, rid, 0, self._seed)
            out.append(tok)
            if max_new == 1 or tok == stop_token:
                return out
            last = tok

        while True:
            inp = to_feed[0] if to_feed else last
            logits, caches = lm.decode_step(self.weights.params(), self.cfg,
                                            self._tokens([[inp]]), caches)
            self.steps += 1
            if to_feed:
                to_feed.pop(0)
                if to_feed:
                    continue                 # still consuming the prompt
            tok = sample_token(logits[0], temperature, rid, len(out),
                               self._seed)
            out.append(tok)
            if len(out) >= max_new or tok == stop_token:
                return out
            last = tok

    def stats(self) -> dict:
        return {"steps": self.steps, "weights": self.weights.describe()}
