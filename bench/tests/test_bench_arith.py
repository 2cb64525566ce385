"""The byte and FLOP counts against numbers worked by hand."""
import json
from pathlib import Path

from bench import flops
from bench.flops import attention_causal, dense_6nd, ssd_chunks
from bench.roofline import b1_bytes

BENCH = Path(__file__).resolve().parents[1]


def model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_b1_bytes():
    # 3 rows: 11 B an element, 4 B a row
    assert b1_bytes.bytes_needed(3072) == 11 * 3072 + 12
    # a partial row counts as a row
    assert b1_bytes.bytes_needed(1025) == 11 * 1025 + 8
    peaks = {"hbm_bytes_s": 3.35e12}
    # 1e9 elements: 11e9 + 4 * 976563 bytes over 3.35 TB/s
    assert abs(b1_bytes.least_seconds(10 ** 9, peaks)
               - (11e9 + 3906252) / 3.35e12) < 1e-15


def test_dense_6nd():
    assert dense_6nd.flops({}, 2, 2048, 1_000) == 6 * 1_000 * 4096


def test_attention_causal_starcoder2():
    m = model("starcoder2-7b.l4")["model"]
    # 3 * 4 * 4096 tokens * 1024 keys * 36 heads * 128 * 4 layers
    assert attention_causal.flops(m, 2, 2048, 0) == 927_712_935_936


def test_ssd_chunks_mamba2():
    m = model("mamba2-1.3b")["model"]
    # per token a layer: 256*128 + 256*4096 + 4*4096*128 = 3,178,496;
    # times 3, 4096 tokens, 48 layers
    assert ssd_chunks.flops(m, 2, 2048, 0) == 3 * 3_178_496 * 4096 * 48
    # no attention layer in mamba2
    assert attention_causal.flops(m, 2, 2048, 0) == 0


def test_step_flops_sums_the_listed_formulas():
    c = model("mamba2-1.3b")
    n = 1_446_714_368
    assert flops.step_flops(c, 2, 2048, n) == (
        6.0 * n * 4096 + 3 * 3_178_496 * 4096 * 48)
