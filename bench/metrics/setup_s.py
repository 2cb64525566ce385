"""From the process's start to the first timed step: imports, CUDA
init, the kernels' build or load, weights, state, the checked and warm-up
steps."""


def read(ctx):
    return ctx.setup_s
