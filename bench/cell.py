"""One run of one training cell: set-up, the checked steps, the timed
window, with `--trace 1` a profiler capture, then the reference and the
result.

Set-up builds the configuration's model with the port
(`repro_torch.models.build`), hands it weights that the benchmark makes
from the seed, builds one `DQGAN` trainer and its state, and drives that
same object through the checked steps, each on its own batch and with
uniform draws that the benchmark makes and hands to `DQGAN.step`, so that
the reference can draw the same; then one step with the trainer's own
draws, the window's path. The window calls `DQGAN.step` on the pool of
batches in a closed loop for `seconds`, each step ending in a
synchronize. Once the window has closed and the peak memory has been
read, the program's state is freed and the reference
(`bench.reference.common.follow`) follows the checked steps from the same
weights, batches and draws; `bench.correct` compares the readings.
"""
from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from bench import correct, inputs, metrics, spec
from bench import trace as TR
from bench.flops import step_flops
from bench.reference import common as RC
from bench.reference import model as reference_model

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def flat(tree, prefix=()):
    """{path tuple: leaf} of a nested dict, in sorted-key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], prefix + (k,)))
    return out


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, the whole name compared."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def smi(query: str) -> str:
    """`nvidia-smi --query-gpu=<query>` of the first card, or why not."""
    try:
        q = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return q.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def card_line(device) -> str:
    if device.type != "cuda":
        return f"# device {device}"
    return (f"# device {torch.cuda.get_device_name(device)}; nvidia-smi: "
            f"{smi('name,power.limit')}")


def host_loop_ms() -> float:
    """The host's speed: a fixed Python loop's wall time."""
    t = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return (time.perf_counter() - t) * 1e3


def check_layout(bundle, wspec):
    """The port's parameter tree (traced on the meta device) against the
    reference's spec: the same paths, shapes and dtypes."""
    port = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in flat(bundle.init(device="meta")).items()}
    ours = {p: (tuple(s), dt) for p, s, dt, _ in wspec}
    if port != ours:
        diff = sorted(set(port.items()) ^ set(ours.items()))
        raise SystemExit(f"bench: the reference's parameters differ from the "
                         f"port's: {diff[:8]}")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Plan:
    """What a cell fixes before any seed: the reference module and its
    parameter spec, the port's model bundle, the comm layout."""

    def __init__(self, cell: spec.Cell):
        from repro_torch.models import build
        self.cell = cell
        self.m = cell.config["model"]
        self.traffic = cell.traffic
        self.strategy = cell.traffic["strategy"]
        self.refmod = reference_model(cell.config["reference"])
        self.wspec = self.refmod.spec(self.m)
        self.n_params = sum(math.prod(shape) for _, shape, _, _ in self.wspec)
        self.bundle = build(spec.model_config(cell.config))
        check_layout(self.bundle, self.wspec)
        self.bucket_bytes = int(self.strategy["bucket_mb"] * (1 << 20))
        self.layout = RC.bucket_layout(
            {p: shape for p, shape, _, _ in self.wspec}, self.bucket_bytes)
        self.total = RC.layout_total(self.layout)


def program_steps(plan: Plan, seed: int, trace: bool, device, log=print):
    """Set-up of one run: the weights, the trainer and its state, the
    batches, and the checked steps on the benchmark's draws. Returns
    (trainer, state, batches, the program's readings)."""
    from repro_torch.core import dqgan
    tr, m = plan.traffic, plan.m
    K = tr["checked_steps"]
    weights = inputs.make_weights(plan.wspec, seed, device)
    w0 = {p: t.clone() for p, t in weights.items()}
    trainer = dqgan.DQGAN(field_fn=plan.bundle.field_fn,
                          dq=spec.strategy(tr, spans=trace), device=device,
                          seed=inputs.sub_seed(seed, 3))
    state = trainer.init(inputs.nest(weights))
    del weights
    batches = inputs.make_batches(tr["batches"], tr["batch"], tr["seq"],
                                  m["vocab_size"], seed, device)
    wire = trainer.comm_ledger(state.params).round_bytes()[0]
    log(f"# {plan.cell.name}: {plan.n_params} parameters, "
        f"{len(plan.layout)} buckets, {plan.total // 1024} rows of 1024, "
        f"batch {tr['batch']} x {tr['seq']}, wire_mb_step {wire / 1e6:.6f} "
        f"(the plan's count)")
    probe = inputs.sub_seed(seed, 4)
    prog = {"loss": []}
    for t in range(K):
        r = inputs.make_draws(plan.total, t, seed, device)
        rand, off = {}, 0
        for bid, (_, size) in enumerate(plan.layout):
            rand[bid] = r[off:off + size]
            off += size
        out = trainer.step(state, batches[t], draws={"rand": rand})
        state = out.state
        del r, rand
        sync(device)
        prog["loss"].append(float(out.metrics["loss"]))
        if t == 0:
            prog["grad"] = RC.readings_of(
                {p: g[0] for p, g in flat(state.prev_grad).items()}, probe)
    params = flat(state.params)
    prog["change"] = RC.readings_of(
        {p: params[p].float() - w0[p].float() for p in params}, probe + 1)
    prog["ef"] = RC.readings_of(
        {p[:-1]: e[0] for p, e in flat(state.ef["leaf"]).items()}, 0,
        sketch=False)
    return trainer, state, batches, prog


def reference_readings(plan: Plan, seed: int, batches, device,
                       compute="f32", half_batch=False):
    """The reference's readings of the checked steps from the same
    weights, batches and draws."""
    K = plan.traffic["checked_steps"]
    return RC.follow(plan.refmod, plan.m,
                     inputs.make_weights(plan.wspec, seed, device),
                     batches[:K],
                     lambda t: inputs.make_draws(plan.total, t, seed, device),
                     K, plan.strategy["lr"], plan.strategy["levels"],
                     inputs.sub_seed(seed, 4), compute=compute,
                     half_batch=half_batch, bucket_bytes=plan.bucket_bytes)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print):
    """Runs the cell once; returns (result dict, [lines for standard
    error]); the result is None where JAX or the JAX package was
    loaded."""
    device = torch.device(device)
    plan = Plan(cell)
    tr = cell.traffic
    K = tr["checked_steps"]
    trainer, state, batches, prog = program_steps(plan, seed, trace, device,
                                                  log)
    # one step on the trainer's own draws: the window's path, warmed up
    nb = len(batches)
    state = trainer.step(state, batches[K % nb]).state
    sync(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window ------------------------------------------------------- #
    # nvidia-smi takes a second or more, and as long again on a busy host:
    # it runs after set-up is read and before the window opens
    card = card_line(device)
    state_line = (f"# before the window: host loop {host_loop_ms():.1f} ms; "
                  f"sm clock, temperature, power "
                  f"{smi('clocks.sm,temperature.gpu,power.draw')}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    i, n, losses = K + 1, 0, []
    t0 = time.perf_counter()
    while True:
        out = trainer.step(state, batches[i % nb])
        state = out.state
        sync(device)
        i, n = i + 1, n + 1
        losses.append(out.metrics["loss"])
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # the cards the run used: those that hold the trained parameters
    n_devices = len({t.device for t in flat(state.params).values()
                     if torch.is_tensor(t)})
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    window = {"steps": n, "seconds": elapsed}
    log(card)
    log(state_line)
    log(f"# after the window: {n} steps in {elapsed:.6f} s; host loop "
        f"{host_loop_ms():.1f} ms; sm clock, temperature, power "
        f"{smi('clocks.sm,temperature.gpu,power.draw')}")
    del out, losses

    cap, cap_wall, alloc = None, 0.0, None
    if trace:
        # the phases' device time, the busy share, the breakdown: a capture
        # without memory events, whose host cost would idle the device
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            tc = time.perf_counter()
            for _ in range(tr["profile_steps"]):
                state = trainer.step(state, batches[i % nb]).state
                i += 1
                sync(device)
            cap_wall = time.perf_counter() - tc
        t_parse = time.perf_counter()
        cap = TR.from_profiler(prof)
        # the phases' allocations: one more step with memory events
        with profile(activities=acts, profile_memory=True) as prof:
            state = trainer.step(state, batches[i % nb]).state
            sync(device)
        alloc = TR.from_profiler(prof).alloc
        del prof
        log(f"# capture: {tr['profile_steps']} steps, {len(cap.device)} "
            f"device events ({cap.unmatched} without a launch), wall "
            f"{cap_wall:.6f} s; with the memory step parsed in "
            f"{time.perf_counter() - t_parse:.1f} s")
    bad = forbidden_modules()

    # ---- the reference ---------------------------------------------------- #
    del state, trainer
    free(device)
    t_ref = time.perf_counter()
    ref = reference_readings(plan, seed, batches, device)
    sync(device)
    log(f"# reference: {K} steps in {time.perf_counter() - t_ref:.1f} s; "
        f"losses program {prog['loss']} reference {ref['loss']}")
    nums = correct.numbers(prog, ref)
    ok, checks = correct.judge(nums, cell.limits)
    log("# numbers " + " ".join(f"{k} {v:.6g}" for k, v in nums.items()))

    # ---- the result ------------------------------------------------------- #
    ctx = SimpleNamespace(
        window=window, peak_bytes=peak, setup_s=setup_s, cap=cap,
        alloc=alloc,
        capture_wall_s=cap_wall, profile_steps=tr["profile_steps"],
        n_params=plan.n_params, peaks=cell.peaks,
        flops_per_step=step_flops(cell.config, tr["batch"], tr["seq"],
                                  plan.n_params))
    wanted = cell.per_layer if trace else cell.end_to_end
    mets = {}
    for entry in wanted:
        v = metrics.read(entry["name"], ctx)
        if v is not None:
            mets[entry["name"]] = {"value": v, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else str(device)),
           "count": n_devices, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": n, "failed": failed,
              "metrics": mets, "device": dev}
    if trace:
        dev["busy_s"] = TR.busy_seconds(cap)
        dev["window_s"] = cap_wall
        result["breakdown"] = {"device_ops": TR.top_device_ops(cap),
                               "idle_gaps": TR.idle_gaps(cap)}
    result["checks"] = checks
    err = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
           for k, c in checks.items()]
    if bad:
        result = None
        err.append(f"bench: modules of JAX or of the JAX package loaded: "
                   f"{bad}")
    return result, err
