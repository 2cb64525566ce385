"""The SSD's chunk products beyond 6 N D (arXiv:2405.21060, the chunked
form), per token of a layer with chunk length L, state size N, H heads of
P channels, causal products counted over the lower triangle (L/2 sources
a token on average), 2 FLOPs a multiply-add, times 3 with the backward:
  C B^T within a chunk          2 * (L/2) * N
  the masked product with x     2 * (L/2) * H * P
  the chunk states              2 * H * P * N
  their read-out                2 * H * P * N
"""


def flops(model, batch, seq, n_params):
    s = model["ssm"]
    L = min(s["chunk_size"], seq)
    N = s["state_dim"]
    HP = s["expand"] * model["d_model"]
    n_ssd = sum(1 for i in range(model["num_layers"])
                if model["layer_pattern"][i % len(model["layer_pattern"])]
                == "ssd")
    per_token = L * N + L * HP + 4.0 * HP * N
    return 3.0 * per_token * batch * seq * n_ssd
