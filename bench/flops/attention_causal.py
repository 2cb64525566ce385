"""Causal self-attention beyond 6 N D: QK^T and PV, 2 FLOPs a
multiply-add each, over S/2 keys on average, times 3 with the backward:
3 * 4 * tokens * (S/2) * H * hd a layer (`launch/dryrun.py`'s
`attention_flops`, copied)."""


def flops(model, batch, seq, n_params):
    n_attn = sum(1 for i in range(model["num_layers"])
                 if model["layer_pattern"][i % len(model["layer_pattern"])]
                 == "attn")
    return (3.0 * 4.0 * batch * seq * (seq / 2) * model["num_heads"]
            * model["head_dim"] * n_attn)
