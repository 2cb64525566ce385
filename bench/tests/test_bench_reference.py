"""The plain reference against the port at a tiny size on the CPU, in
float32: one field evaluation (loss and every gradient) of a
starcoder2-like and of a mamba2-like model, and the comm layout whose
blocks the quantizer shares."""
import json

import pytest

from bench import cell, inputs, spec
from bench.reference import common as RC
from bench.reference import model as reference_model
from bench.tests.tiny import ROOT, SIZES


def tiny(name):
    cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    cfg["model"].update(SIZES[name], param_dtype="float32")
    return cfg


@pytest.mark.parametrize("flip_head", [False, True],
                         ids=["configured_head", "other_head"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_field_matches_the_port(name, flip_head):
    """other_head: the unembedding tied where the configuration keeps its
    own, and its own where the configuration ties it."""
    from repro_torch.models import build
    cfg = tiny(name)
    if flip_head:
        cfg["model"]["tie_embeddings"] = not cfg["model"]["tie_embeddings"]
    m = cfg["model"]
    ref = reference_model(cfg["reference"])
    wspec = ref.spec(m)
    bundle = build(spec.model_config(cfg))
    cell.check_layout(bundle, wspec)
    w = inputs.make_weights(wspec, 2 ** 31 + 5, "cpu")
    batch = inputs.make_batches(1, 2, 64, m["vocab_size"], 7, "cpu")[0]
    grads, met = bundle.field_fn(inputs.nest(w), batch)
    loss, rgrads = ref.loss_and_grads(w, m, batch)
    assert float(met["loss"]) == pytest.approx(float(loss), rel=1e-5)
    port = cell.flat(grads)
    assert set(port) == set(rgrads)
    for p, g in rgrads.items():
        scale = float(g.abs().max()) + 1e-12
        assert float((port[p] - g).abs().max()) <= 1e-4 * scale, p


@pytest.mark.parametrize("name", sorted(SIZES))
def test_layout_matches_the_port(name):
    from repro_torch.core import dqgan
    from repro_torch.models import build
    cfg = tiny(name)
    traffic = {"strategy": {"optimizer": "omd", "message": "update",
                            "lr": 1e-4, "compressor": "qsgd8_block1024",
                            "plan": "uniform", "bucket_mb": 0.01}}
    bundle = build(spec.model_config(cfg))
    wspec = reference_model(cfg["reference"]).spec(cfg["model"])
    w = inputs.make_weights(wspec, 3, "cpu")
    tr = dqgan.DQGAN(field_fn=bundle.field_fn,
                     dq=spec.strategy(traffic, spans=False), device="cpu")
    port = tr._comm(inputs.nest(w))[0]
    ours = RC.bucket_layout({p: tuple(t.shape) for p, t in w.items()},
                            int(0.01 * (1 << 20)))
    assert [b.size for b in port.buckets] == [s for _, s in ours]
    assert [len(b.slots) for b in port.buckets] == [len(p) for p, _ in ours]
    assert not port.skipped
