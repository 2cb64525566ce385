"""Structural checks over the collectives of a profiled step — the
counterpart of `repro.obs.hlo`, which reads them off the compiled step's
optimized HLO. The port's step runs eagerly, so its collectives are read
off a `torch.profiler` capture of the step instead (``record_shapes=True``;
`capture` takes one):

* every collective call leaves the dispatcher's ``c10d::<op>`` operator
  on the calling thread, inside the ``repro.obs/<phase>`` range
  (`tracing.device_span`) that made the call, and the backend's record of
  the call with its input's shape and dtype (``gloo:<op>``, which gloo
  makes on its worker thread, outside any range; ``nccl:<op>`` where
  NCCL leaves one). The two are paired in order within each kind of
  collective, and a capture where they do not pair up is refused (gloo
  records a reduce-scatter as the all-reduce it runs; such a call counts
  by its own record of its output). A call is attributed to the phase of
  its ``c10d::`` operator and timed by its start. (The checks are
  exercised over gloo ranks.)
* a collective's bytes are its result's, what the call's output holds on
  this rank (the output tensor the call records, or for all_reduce, whose
  output is its input, the backend's record of the input): the quantity
  `repro.obs.hlo` reads as an HLO collective's result bytes.
* a collective of the model group (the tensor-parallel 'model' axis:
  the field's all-reduces and gathers, a sharded leaf's scale) is called
  inside a `parallel.tensor.MODEL_GROUP_RANGE` range and counts under
  group "model", apart from the exchange's ("data"); one of the fsdp
  layout's data group (`parallel.fsdp.FSDP_GROUP_RANGE`: the parameter
  all-gathers and gradient reduce-scatters) under group "fsdp": the
  summaries and checks below read the data group's unless told
  otherwise, so the byte check against the ledger compares the exchange
  alone.

Functions:

* `collectives(prof)` — the step's collective calls, in call order.
* `collective_summary(prof, phase=None, group="data")` — per-kind
  counts, bytes and int8 bytes (``all-reduce`` / ``all-gather`` /
  ``all-to-all`` / ...).
* `byte_gap(prof, ledger, participants)` — the exchange phase's bytes
  against the `CommLedger`'s bill for one round. The ledger bills a ring
  all-reduce at 2·(W−1)/W × payload (send+receive); a collective's result
  holds the payload once, so ``modeled_result_bytes = carried /
  transport_factor`` as in `repro.obs.hlo.byte_gap`.
* `check_schedule_structure` / `assert_schedule_structure` — an exchange
  step calls at least one all-reduce-class collective in its exchange
  phase; a `local_k` mid-round step calls no payload-sized collective;
  under ``overlap=True`` the exchange's first collective starts before the
  field's first operator (the eager counterpart of the JAX check that the
  exchange collectives are DAG-independent of the field).

The step's own metric reductions (the mean of loss/grad_norm/error_norm
over the workers, the staleness max, the obs sums) are collectives too,
called outside the exchange phase. As in `repro.obs.hlo`, they are told
apart from the exchange's by phase where spans are on and by size in the
mid-round check: a few scalars against a bucket's payload.
* `check_fsdp_structure` / `assert_fsdp_structure` — a ZeRO-shaped
  step: a scatter collective (reduce-scatter or all-to-all) and an
  all-gather, all-reduce bytes below half of their payload, and int8
  bytes on the wire when compressed (the rules of
  `repro.obs.hlo.check_fsdp_structure`, over the exchange and apply
  phases where spans are on: fsdp's all-gather runs in its apply phase).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.core.exchange import transport_factor
from repro_torch.parallel.fsdp import FSDP_GROUP_RANGE
from repro_torch.parallel.tensor import MODEL_GROUP_RANGE

from .profile import phase_of
from .tracing import PREFIX

ALL_REDUCE_CLASS = ("all-reduce", "reduce-scatter", "all-gather")

_KINDS = (("reducescatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("allgather", "all-gather"), ("alltoall", "all-to-all"),
          ("broadcast", "broadcast"))
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
                "signed char": 1, "unsigned char": 1, "bool": 1,
                "short int": 2, "int": 4, "long int": 8}


def _kind(name: str) -> Optional[str]:
    key = name.split(":")[-1].replace("_", "").lower()
    for frag, kind in _KINDS:
        if frag in key:
            return kind
    return None


class Collective(NamedTuple):
    kind: str              # "all-reduce", "all-gather", "all-to-all", ...
    phase: Optional[str]   # the repro.obs/ phase that called it, or None
    start_us: float        # call time (the c10d:: operator's start)
    bytes: int             # the result's bytes on this rank
    dtype: str             # the result's element type
    group: str = "data"    # "model" / "fsdp": a model / fsdp group's


# a field group's profiler range -> the group its collectives count under
_GROUP_RANGES = ((MODEL_GROUP_RANGE, "model"), (FSDP_GROUP_RANGE, "fsdp"))


def _model_range(event):
    """The MODEL_GROUP_RANGE (or FSDP_GROUP_RANGE) range around a call,
    or None."""
    e = event
    while e is not None:
        if any(e.name.startswith(r + ":") for r, _ in _GROUP_RANGES):
            return e
        e = e.cpu_parent
    return None


def _group_of(event) -> str:
    rng = _model_range(event)
    if rng is None:
        return "data"
    return next(g for r, g in _GROUP_RANGES if rng.name.startswith(r + ":"))


def _pair(calls, records):
    """(call, record) pairs of one kind. Each process group's backend
    records its calls in order on its own threads, so the groups' records
    interleave apart from the calls: a model-group call takes the first
    later record of the shape its range names, and the data group's
    calls the rest, in order."""
    records = list(records)
    pairs, data_calls = [], []
    for c in calls:
        rng = _model_range(c)
        if rng is None:
            data_calls.append(c)
            continue
        shape = [int(d) for d in rng.name.rpartition(":")[2]
                 .split(",") if d]
        i = next((i for i, r in enumerate(records)
                  if r.time_range.start >= c.time_range.start
                  and r.input_shapes and list(r.input_shapes[0]) == shape),
                 None)
        if i is None:
            raise ValueError(f"obs.trace: no backend record of the model "
                             f"group's {c.name} over {shape}")
        pairs.append((c, records.pop(i)))
    return pairs + list(zip(data_calls, records))


def capture(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the `torch.profiler` capture of the call):
    CPU activity, where the collective calls and the backends' records
    are, with shapes recorded. Where the process uses a CUDA device, the
    capture ends after the device has finished the call's work."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return out, prof


def _dtypes(prof) -> Dict[int, list]:
    """{operator id: its inputs' dtype names} from the Kineto records."""
    return {k.correlation_id(): list(k.dtypes())
            for k in prof.profiler.kineto_results.events()}


def collectives(prof) -> List[Collective]:
    """Every collective call of a capture, in call order (see the module
    docstring). Raises where the dispatcher's calls and the backend's
    records of a kind do not pair up."""
    cpu = torch.autograd.DeviceType.CPU
    events = sorted((e for e in prof.events() if e.device_type == cpu),
                    key=lambda e: e.time_range.start)
    calls: Dict[str, list] = {}
    records: Dict[str, list] = {}
    for e in events:
        kind = _kind(e.name)
        if kind is None:
            continue
        if e.name.startswith("c10d::"):
            calls.setdefault(kind, []).append(e)
        elif e.name.startswith(("gloo:", "nccl:")):
            records.setdefault(kind, []).append(e)
    _claim_gloo_reduce_scatters(calls, records)
    dtypes = _dtypes(prof)
    out = []
    for kind, cs in calls.items():
        rs = records.get(kind, [])
        if len(rs) != len(cs):
            raise ValueError(
                f"obs.trace: {len(cs)} c10d {kind} call(s) but {len(rs)} "
                f"backend record(s); is the capture's record_shapes on?")
        for c, r in _pair(cs, rs):
            # the call's output tensor (its first input) where it records
            # one; all_reduce takes a tensor list: its record's input
            src, i = (c, 0) if c.input_shapes and c.input_shapes[0] \
                else (r, 0)
            shape = src.input_shapes[i]
            dts = dtypes.get(src.id) or []
            dtype = dts[i] if i < len(dts) else ""
            if dtype not in _DTYPE_BYTES:
                raise ValueError(f"obs.trace: {src.name}: no byte size for "
                                 f"dtype {dtype!r}")
            n = 1
            for d in shape:
                n *= int(d)
            out.append(Collective(kind, phase_of(c), c.time_range.start,
                                  n * _DTYPE_BYTES[dtype], dtype,
                                  _group_of(c)))
    return sorted(out, key=lambda c: c.start_us)


def _claim_gloo_reduce_scatters(calls, records):
    """gloo runs a reduce-scatter as an all-reduce of its whole input, so
    its record reads ``gloo:all_reduce``. Where the reduce-scatter calls
    have no records of their own, each takes out of the all-reduce
    records the first one after it over an input of its input's shape
    (which of two such records it takes changes no count and no byte),
    and is its own record: the call records its output."""
    rs = calls.get("reduce-scatter", [])
    if not rs or records.get("reduce-scatter"):
        return
    ars = records.get("all-reduce", [])
    for c in rs:
        shape = c.input_shapes[1] if len(c.input_shapes) > 1 else None
        i = next((i for i, r in enumerate(ars)
                  if r.input_shapes and r.input_shapes[0] == shape
                  and r.time_range.start >= c.time_range.start), None)
        if i is None:
            raise ValueError(f"obs.trace: no backend record of the "
                             f"reduce-scatter over {shape}")
        ars.pop(i)
    records["reduce-scatter"] = list(rs)


def spans_present(prof) -> bool:
    """True when the capture holds ``repro.obs/`` ranges."""
    return any(e.name.startswith(PREFIX) for e in prof.events())


def _summary(colls: List[Collective]) -> dict:
    out: Dict[str, dict] = {}
    for c in colls:
        rec = out.setdefault(c.kind, {"count": 0, "bytes": 0,
                                      "int8_bytes": 0})
        rec["count"] += 1
        rec["bytes"] += c.bytes
        if c.dtype in ("signed char", "unsigned char"):
            rec["int8_bytes"] += c.bytes
    return out


def collective_summary(prof, phase: Optional[str] = None,
                       group: Optional[str] = "data") -> dict:
    """{kind: {count, bytes, int8_bytes}} of a capture's collectives of
    `group` ("data", the exchange's; "model"; "fsdp"; None: all), of those
    `phase` called, given one."""
    return _summary([c for c in collectives(prof)
                     if (phase is None or c.phase == phase)
                     and (group is None or c.group == group)])


def _class_totals(colls: dict) -> dict:
    return {k: sum(v[k] for kind, v in colls.items()
                   if kind in ALL_REDUCE_CLASS)
            for k in ("count", "bytes", "int8_bytes")}


# --------------------------------------------------------------------------- #
def byte_gap(prof, ledger, participants: Optional[int] = None) -> dict:
    """Measured-vs-modeled bytes: what the exchange phase's collectives
    hold on this rank vs what the `CommLedger` bills one round at.
    ``gap_ratio`` is measured / modeled_result − 1. Needs spans on."""
    if not spans_present(prof):
        raise ValueError("obs.trace.byte_gap needs a step captured with "
                         "spans on (Observability(spans=True))")
    colls = collective_summary(prof, "exchange")
    measured = float(sum(v["bytes"] for v in colls.values()))
    wire, carried = ledger.round_bytes(participants)
    transport = transport_factor(max(ledger.n_workers, 2))
    modeled_result = carried / transport if transport else carried
    return {
        "collectives": colls,
        "measured_bytes": measured,
        "measured_int8_bytes": float(sum(v["int8_bytes"]
                                         for v in colls.values())),
        "modeled_wire_bytes": wire,
        "modeled_carried_bytes": carried,
        "modeled_result_bytes": modeled_result,
        "gap_ratio": (measured / modeled_result - 1.0
                      if modeled_result else None),
        "per_bucket": ledger.per_bucket(participants),
    }


# --------------------------------------------------------------------------- #
def _field_start(prof) -> Optional[float]:
    starts = [e.time_range.start for e in prof.events()
              if e.name == PREFIX + "field"]
    return min(starts) if starts else None


def check_schedule_structure(schedule, exchange_prof, midround_prof=None,
                             overlap: bool = False) -> dict:
    """Schedule-shaped checks over captured steps. ``schedule`` is a
    `strategy.Schedule`; ``exchange_prof`` a capture of an exchange step,
    ``midround_prof`` (local_k only) one of a mid-round step. Returns
    {"ok": bool, "violations": [...], ...evidence};
    `assert_schedule_structure` raises on violations."""
    violations: List[str] = []
    spans = spans_present(exchange_prof)
    ex_colls = collective_summary(exchange_prof,
                                  "exchange" if spans else None)
    ex_cls = _class_totals(ex_colls)
    report: Dict[str, object] = {
        "schedule": f"{schedule.kind}(k={schedule.k},tau={schedule.tau})",
        "exchange_collectives": ex_colls,
        "exchange_class_totals": ex_cls,
    }
    if ex_cls["count"] < 1:
        violations.append(
            f"exchange step calls no all-reduce-class collective"
            f"{' in its exchange phase' if spans else ''} (got "
            f"{sorted(ex_colls)})")
    if schedule.kind == "local_k":
        if midround_prof is None:
            violations.append("local_k structure check needs a capture of "
                              "a mid-round step")
        else:
            mid_colls = collective_summary(midround_prof)
            mid_cls = _class_totals(mid_colls)
            report["midround_collectives"] = mid_colls
            report["midround_class_totals"] = mid_cls
            # the metric reductions remain (a few scalars); the payload
            # must not reach the wire between rounds
            if mid_cls["int8_bytes"] > 0:
                violations.append(
                    f"mid-round step moves quantized payload "
                    f"({mid_cls['int8_bytes']} int8 bytes)")
            biggest = max((c.bytes for c in collectives(exchange_prof)
                           if c.phase == "exchange" or not spans),
                          default=0)
            mid_big = max((c.bytes for c in collectives(midround_prof)),
                          default=0)
            report["midround_largest_bytes"] = mid_big
            if biggest and mid_big >= 0.5 * biggest:
                violations.append(
                    f"mid-round step calls a {mid_big}-byte collective, "
                    f"not < half the exchange's largest ({biggest}) — the "
                    f"accumulator is leaking onto the wire between rounds")
    if overlap:
        if schedule.kind != "delayed":
            violations.append(
                f"overlap structure is only defined for the delayed "
                f"schedule, not {schedule.kind!r}")
        elif not spans:
            violations.append(
                "overlap check needs a capture with spans on "
                "(Observability(spans=True))")
        else:
            first = min((c.start_us for c in collectives(exchange_prof)
                         if c.phase == "exchange"), default=None)
            field = _field_start(exchange_prof)
            report["overlap_order"] = {"first_exchange_collective_us": first,
                                       "field_start_us": field}
            if first is None:
                violations.append("overlap step calls no exchange-phase "
                                  "collective")
            elif field is None:
                violations.append("overlap step has no field phase")
            elif not first < field:
                violations.append(
                    f"the exchange's first collective starts at {first:.1f} "
                    f"us, not before the field at {field:.1f} us: it waits "
                    f"for the round's field (no overlap possible)")
    report["ok"] = not violations
    report["violations"] = violations
    return report


def assert_schedule_structure(schedule, exchange_prof, midround_prof=None,
                              overlap: bool = False) -> dict:
    report = check_schedule_structure(schedule, exchange_prof, midround_prof,
                                      overlap=overlap)
    if not report["ok"]:
        raise AssertionError(
            f"schedule structure violated for {report['schedule']}: "
            + "; ".join(report["violations"]))
    return report


# --------------------------------------------------------------------------- #
def check_fsdp_structure(prof, compressed: bool = False) -> dict:
    """FSDP-shaped checks over a captured step (the rules of
    `repro.obs.hlo.check_fsdp_structure`). A ZeRO step calls a *scatter*
    collective (reduce-scatter for the exact path, all-to-all for the
    quantized two_phase path) to move each worker's shard in, and an
    all-gather to send the shard update (zero-2) or the updated shard
    parameters (zero-3) back out. It must not fall back to whole-payload
    all-reduces: the all-reduces left are the metric reductions, small
    next to the scatter and gather payload. With ``compressed=True`` the
    payload must also ride as int8. Where spans are on, only the exchange
    and apply phases' collectives count (the fsdp round spans both).
    Returns {"ok": bool, "violations": [...], ...evidence};
    `assert_fsdp_structure` raises on violations."""
    violations: List[str] = []
    spans = spans_present(prof)
    colls = _summary([c for c in collectives(prof)
                      if not spans or c.phase in ("exchange", "apply")])

    def cat(name):
        return colls.get(name, {"count": 0, "bytes": 0, "int8_bytes": 0})

    scatter_ops = cat("reduce-scatter")["count"] + cat("all-to-all")["count"]
    scatter_bytes = cat("reduce-scatter")["bytes"] + cat("all-to-all")["bytes"]
    gather = cat("all-gather")
    ar = cat("all-reduce")
    payload_bytes = scatter_bytes + gather["bytes"]
    report: Dict[str, object] = {
        "collectives": colls,
        "scatter_ops": scatter_ops,
        "scatter_bytes": scatter_bytes,
        "all_gather_ops": gather["count"],
        "all_gather_bytes": gather["bytes"],
        "all_reduce_bytes": ar["bytes"],
    }
    if scatter_ops < 1:
        violations.append(
            f"fsdp exchange step calls no scatter collective "
            f"(reduce-scatter or all-to-all); got {sorted(colls)}")
    if gather["count"] < 1:
        violations.append(
            "fsdp exchange step calls no all-gather (the shard "
            "update/params never return to the other workers)")
    if payload_bytes and ar["bytes"] >= 0.5 * payload_bytes:
        violations.append(
            f"all-reduce bytes ({ar['bytes']:.0f}) not < half the "
            f"scatter+gather payload ({payload_bytes:.0f}) — the fsdp "
            f"step is moving whole-payload all-reduces")
    if compressed:
        i8 = sum(v["int8_bytes"] for v in colls.values())
        report["int8_bytes"] = i8
        if i8 <= 0:
            violations.append(
                "compressed fsdp step moves no int8 payload on the wire")
    report["ok"] = not violations
    report["violations"] = violations
    return report


def assert_fsdp_structure(prof, compressed: bool = False) -> dict:
    report = check_fsdp_structure(prof, compressed=compressed)
    if not report["ok"]:
        raise AssertionError("fsdp structure violated: "
                             + "; ".join(report["violations"]))
    return report
