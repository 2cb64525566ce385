"""The comparison that decides `correct`: the program's readings of its
first checked steps against the reference's of the same steps.

Readings (`reference.common.follow` makes the reference's; the run makes
the program's from its state): each step's loss; the first gradient's
norm and sketch (its inner product with a seeded normal probe) per leaf;
the parameters' change over the checked steps, norm and sketch per leaf;
the error-feedback residual's norm per leaf after them.

Numbers (each the worst over the leaves, as a share of the reference's
norm of that leaf or of the median leaf, whichever is larger):
  loss_gap           max over steps |loss_p - loss_r| / |loss_r|
  grad_norm_gap      | |g_p| - |g_r| |
  grad_sketch_gap    the root mean square over the probes r_j of
                     <g_p, r_j> - <g_r, r_j>, against |g_r|
  grad_sketch_rms    the same leaf by leaf, its root mean square over the
                     leaves (not the worst leaf)
  change_norm_gap    | |dw_p| - |dw_r| |
  change_sketch_gap  as grad_sketch_gap, of dw
  ef_norm_gap        | |e_p| - |e_r| |
The change and residual numbers leave out the leaves whose reference
gradient is under a thousandth of the median leaf's (nought to rounding).
"""
from __future__ import annotations

import math
import statistics

def _gaps(prog, ref, keep, use_sketch):
    """{leaf: gap} of `prog` against `ref` ({leaf: (norm, [sketches])})."""
    leaves = [k for k in ref if k in keep]
    med = statistics.median(ref[k][0] for k in leaves)
    out = {}
    for k in leaves:
        if k not in prog:
            out[k] = math.inf
            continue
        base = max(ref[k][0], med)
        if base == 0:
            continue
        if use_sketch:
            d = [a - b for a, b in zip(prog[k][1], ref[k][1])]
            gap = math.sqrt(sum(x * x for x in d) / len(d)) / base
        else:
            gap = abs(prog[k][0] - ref[k][0]) / base
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(prog, ref, keep, use_sketch):
    """(the worst leaf's gap, that leaf)."""
    gaps = _gaps(prog, ref, keep, use_sketch)
    return max(((v, k) for k, v in gaps.items()), default=(0.0, None))


def numbers(prog: dict, ref: dict, where: dict = None) -> dict:
    """{number: value} of the program's readings against the reference's;
    `where`, given, gets the worst leaf of each."""
    grad = ref["grad"]
    med = statistics.median(v[0] for v in grad.values())
    moving = {k for k, v in grad.items() if v[0] >= 1e-3 * med}
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    else:
        loss = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                   for a, b in zip(prog["loss"], ref["loss"]))
    leafy = {
        "grad_norm_gap": _worst(prog["grad"], grad, set(grad), False),
        "grad_sketch_gap": _worst(prog["grad"], grad, set(grad), True),
        "change_norm_gap": _worst(prog["change"], ref["change"], moving,
                                  False),
        "change_sketch_gap": _worst(prog["change"], ref["change"], moving,
                                    True),
        "ef_norm_gap": _worst(prog["ef"], ref["ef"], moving, False),
    }
    if where is not None:
        where.update({k: v[1] for k, v in leafy.items()})
    g = list(_gaps(prog["grad"], grad, set(grad), True).values())
    rms = math.sqrt(sum(x * x for x in g) / len(g))
    out = {"loss_gap": loss, **{k: v[0] for k, v in leafy.items()}}
    out["grad_sketch_rms"] = rms if math.isfinite(rms) else math.inf
    return out


def judge(nums: dict, limits: dict):
    """(correct, {number: {"value", "limit"}}) of the compared numbers:
    each under its limit, none missing, none NaN."""
    checks = {}
    ok = True
    for name, lim in limits.items():
        v = nums.get(name, math.nan)
        checks[name] = {"value": v, "limit": lim["limit"]}
        if not (v <= lim["limit"]):
            ok = False
    return ok, checks
