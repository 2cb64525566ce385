"""6 N D: a forward and a backward matmul pass over every parameter for
each token (`launch/dryrun.py`'s `model_flops`, copied)."""


def flops(model, batch, seq, n_params):
    return 6.0 * n_params * batch * seq
