"""δ-approximate gradient compressors (paper §2.4, §3.2, Theorems 1–2).

Counterpart of `repro.core.compressors`, with the same registry names,
payload layouts and `wire_bytes`. A compressor is a frozen dataclass:

    payload = c.compress(v, rand=None, generator=None)
    v_hat   = c.decompress(payload, shape, dtype)
    c.wire_bytes(shape, n_workers)    # modeled PS-uplink bytes per worker
    c.delta(d)                        # analytic δ lower bound (or None)

Stochastic compressors draw from `generator` on v's device, or take their
draws as `rand`: a uniform tensor of the blocked shape for the quantizers,
the chosen index tensor for `RandK`. Tests hand them the JAX package's
draws that way, since the two frameworks' generators never agree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

_EPS = 1e-20


def _flat(v):
    return v.reshape(-1)


def _uniform(shape, like, rand, generator):
    if rand is not None:
        return rand.reshape(shape)
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=torch.float32)


def _stochastic_round_codes(fb, s, levels, rand=None, generator=None):
    """Blocked stochastic rounding to signed integer levels:
    sign(v)·(floor(|v|/s·L) + (u < frac)). This is not the fused kernel's
    signed floor(m/s·L); each mirrors its JAX counterpart as written."""
    lv = fb.abs() / s * levels                  # in [0, levels]
    low = torch.floor(lv)
    p_up = lv - low
    up = _uniform(fb.shape, fb, rand, generator) < p_up
    q = low + up.to(lv.dtype)                   # stochastic level
    return (torch.sign(fb) * q).to(torch.int8)


def _dequantize_codes(payload, shape, dtype, levels):
    d = math.prod(shape)
    deq = payload["codes"].float() * (payload["scale"] / levels)
    return deq.reshape(-1)[:d].reshape(shape).to(dtype)


@dataclass(frozen=True)
class Compressor:
    name: str = "identity"

    def compress(self, v, rand=None, generator=None):
        return {"values": v}

    def decompress(self, payload, shape, dtype):
        return payload["values"].to(dtype)

    def wire_bytes(self, shape, n_workers: int = 1) -> int:
        del n_workers
        return 4 * math.prod(shape)

    def delta(self, d: int) -> Optional[float]:
        return 1.0

    @property
    def unbiased(self) -> bool:
        return True


@dataclass(frozen=True)
class TopK(Compressor):
    """Keep the k = ceil(frac·d) largest-magnitude entries (δ = k/d).
    Biased; needs error feedback. Payload: int32 indices + values."""
    name: str = "topk"
    frac: float = 0.01

    def _k(self, d):
        return max(1, int(math.ceil(self.frac * d)))

    def compress(self, v, rand=None, generator=None):
        f = _flat(v)
        idx = torch.topk(f.abs(), self._k(f.shape[0])).indices
        return {"indices": idx.to(torch.int32), "values": f[idx]}

    def decompress(self, payload, shape, dtype):
        d = math.prod(shape)
        vals = payload["values"]
        out = torch.zeros((d,), dtype=vals.dtype, device=vals.device)
        out[payload["indices"].long()] = vals
        return out.reshape(shape).to(dtype)

    def wire_bytes(self, shape, n_workers: int = 1) -> int:
        return 8 * self._k(math.prod(shape))

    def delta(self, d):
        return self._k(d) / d

    @property
    def unbiased(self):
        return False


@dataclass(frozen=True)
class RandK(Compressor):
    """Keep k uniformly random coordinates (unscaled contraction, δ = k/d
    in expectation). `rand`, when given, is the (k,) index tensor."""
    name: str = "randk"
    frac: float = 0.01

    def _k(self, d):
        return max(1, int(math.ceil(self.frac * d)))

    def compress(self, v, rand=None, generator=None):
        f = _flat(v)
        d = f.shape[0]
        if rand is None:
            rand = torch.randperm(d, generator=generator,
                                  device=f.device)[:self._k(d)]
        idx = rand.long()
        return {"indices": idx.to(torch.int32), "values": f[idx]}

    decompress = TopK.decompress

    def wire_bytes(self, shape, n_workers: int = 1) -> int:
        return 8 * self._k(math.prod(shape))

    def delta(self, d):
        return self._k(d) / d

    @property
    def unbiased(self):
        return False


@dataclass(frozen=True)
class SignMean(Compressor):
    """Q(v) = sign(v)·mean(|v|): 1 bit + one scale (EF-signSGD)."""
    name: str = "sign"

    def compress(self, v, rand=None, generator=None):
        f = _flat(v)
        scale = f.abs().mean()
        bits = (f >= 0).to(torch.int8)  # one byte in payload; 1 bit on wire
        return {"codes": bits, "scale": scale.float()}

    def decompress(self, payload, shape, dtype):
        signs = payload["codes"].float() * 2.0 - 1.0
        return (signs * payload["scale"]).reshape(shape).to(dtype)

    def wire_bytes(self, shape, n_workers: int = 1) -> int:
        return math.prod(shape) // 8 + 4

    def delta(self, d):
        return None  # data dependent

    @property
    def unbiased(self):
        return False


@dataclass(frozen=True)
class StochasticQuant(Compressor):
    """m-bit stochastic uniform quantization (QSGD / Hou et al.): codes are
    signed integer levels in int8, scale = ||v||₂ or ||v||∞ per block
    (``per_block > 0``) or per tensor. Payload: codes (R, B) int8 + scale
    (R, 1) f32; wire bytes = d·bits/8 + 4 per scale."""
    name: str = "qsgd"
    bits: int = 8
    norm: str = "linf"  # "l2" | "linf"
    per_block: int = 0

    def __post_init__(self):
        if not 2 <= self.bits <= 8:
            raise ValueError("codes are carried as int8: 2 <= bits <= 8")
        if self.norm not in ("l2", "linf"):
            raise ValueError(f"norm must be 'l2' or 'linf', got {self.norm!r}")

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def _scale(self, f):
        if self.norm == "l2":
            return torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        return f.abs().amax(dim=-1, keepdim=True)

    def _blocked(self, f):
        d = f.shape[0]
        if self.per_block <= 0:
            return f[None, :], d
        b = self.per_block
        f = F.pad(f, (0, (-d) % b))
        return f.reshape(-1, b), d

    def compress(self, v, rand=None, generator=None):
        fb, _ = self._blocked(_flat(v).float())
        s = self._scale(fb) + _EPS
        codes = _stochastic_round_codes(fb, s, self.levels, rand, generator)
        return {"codes": codes, "scale": s.float()}

    def decompress(self, payload, shape, dtype):
        return _dequantize_codes(payload, shape, dtype, self.levels)

    def wire_bytes(self, shape, n_workers: int = 1) -> int:
        d = math.prod(shape)
        n_scales = 1 if self.per_block <= 0 else -(-d // self.per_block)
        return d * self.bits // 8 + 4 * n_scales

    def delta(self, d):
        return None  # measured in tests

    @property
    def unbiased(self):
        return True


class TracedQuant:
    """`StochasticQuant(norm="linf")` whose level count is a device tensor
    (counterpart of `repro.core.compressors.TracedQuant`).

    The adaptive PlanFamily (comm.planner) picks each bucket's bit-width
    per round from a table indexed by the round's participant count. Every
    member shares one payload layout (int8 codes + f32 scales, shapes set
    by ``per_block``), so only the level count varies; it stays on the
    device as a 0-d or one-element float32 tensor (or a Python int), and
    `error_feedback.compress_with_ef` hands it to the fused kernel's
    dynamic-levels variant. Built per step; not a registry entry.
    """

    norm = "linf"
    bits = None          # not known on the host
    unbiased = True
    _blocked = StochasticQuant._blocked

    def __init__(self, levels, per_block: int = 0,
                 name: str = "adaptive_linf"):
        self.levels = levels
        self.per_block = per_block
        self.name = name

    def compress(self, v, rand=None, generator=None):
        fb, _ = self._blocked(_flat(v).float())
        s = fb.abs().amax(dim=-1, keepdim=True) + _EPS
        codes = _stochastic_round_codes(fb, s, self.levels, rand, generator)
        return {"codes": codes, "scale": s.float()}

    def decompress(self, payload, shape, dtype):
        return _dequantize_codes(payload, shape, dtype, self.levels)


# --------------------------------------------------------------------------- #
# registry: names usable in DQConfig.compressor (same as repro's)
# --------------------------------------------------------------------------- #
REGISTRY = {
    "identity": Compressor(),
    "topk1": TopK(frac=0.01),
    "topk10": TopK(name="topk10", frac=0.10),
    "randk1": RandK(frac=0.01),
    "sign": SignMean(),
    # l2 scaling is a contraction only with blocks (QSGD buckets at 512)
    "qsgd8_l2": StochasticQuant(name="qsgd8_l2", bits=8, norm="l2",
                                per_block=512),
    "qsgd8_l2_global": StochasticQuant(name="qsgd8_l2_global", bits=8,
                                       norm="l2"),
    "qsgd8_linf": StochasticQuant(name="qsgd8_linf", bits=8, norm="linf"),
    "qsgd4_linf": StochasticQuant(name="qsgd4_linf", bits=4, norm="linf"),
    # 2-bit linf: levels = 1, stochastic ternary {-s, 0, +s}
    "qsgd2_linf": StochasticQuant(name="qsgd2_linf", bits=2, norm="linf"),
    "qsgd8_block256": StochasticQuant(
        name="qsgd8_block256", bits=8, norm="linf", per_block=256),
    # one scale per 1024-element row: the bucket-native quantizer, which
    # error_feedback.compress_with_ef runs through the fused CUDA kernel
    "qsgd8_block1024": StochasticQuant(
        name="qsgd8_block1024", bits=8, norm="linf", per_block=1024),
    "qsgd4_block1024": StochasticQuant(
        name="qsgd4_block1024", bits=4, norm="linf", per_block=1024),
    "qsgd2_block1024": StochasticQuant(
        name="qsgd2_block1024", bits=2, norm="linf", per_block=1024),
}


def get(name: str) -> Compressor:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(REGISTRY)}")
