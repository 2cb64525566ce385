"""In percent: the step's model FLOPs (`bench/flops/`, the
configuration's formulas) over the step time of the traced run's window,
which the profiler does not cover, over the card's dense bf16 peak."""


def read(ctx):
    w = ctx.window
    if not w or not w["steps"]:
        return None
    step_s = w["seconds"] / w["steps"]
    return 100.0 * ctx.flops_per_step / step_s / ctx.peaks["bf16_flop_s"]
