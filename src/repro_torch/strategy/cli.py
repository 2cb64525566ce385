"""CLI auto-generation from the component schemas (counterpart of
`repro.strategy.cli`, DESIGN.md §9.4).

`launch.train`'s strategy flags are generated from the dataclass fields
of each component (the ``metadata`` attached in components.py), so the
argparse surface, the typed API and the JSON schema are one definition.
The generated flags keep the legacy spellings (``--compressor``,
``--comm-plan``, ``--schedule``, ``--staleness-tau``, ...), plus:

    --preset NAME          start from a registry preset
    --strategy-json X      start from a JSON file path (or inline JSON)

Explicit flags override the preset/JSON base, which overrides the
defaults. `worker_axes` never has a flag — the launcher derives it from
the actual mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

from .components import (
    Compression,
    ExchangePlan,
    MomentCompression,
    Observability,
    Participation,
    Schedule,
)
from .presets import PRESETS, get_preset
from .strategy import Strategy

_COMPONENTS = (Compression, ExchangePlan, Schedule, Participation,
               MomentCompression, Observability)


def _cli_fields():
    """(component class, dataclass field, metadata) for every flag-backed
    field, in declaration order."""
    for cls in _COMPONENTS:
        for f in dataclasses.fields(cls):
            meta = dict(f.metadata) if f.metadata else {}
            if "legacy" in meta:
                yield cls, f, meta


def add_strategy_args(ap: argparse.ArgumentParser) -> None:
    """Add the auto-generated strategy flags to `ap`. All flags default
    to argparse.SUPPRESS so `strategy_from_args` can tell 'explicitly
    passed' from 'left at default'."""
    g = ap.add_argument_group(
        "strategy", "distribution strategy (repro.strategy; flags are "
                    "generated from the component schemas)")
    g.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="start from a named strategy preset")
    g.add_argument("--strategy-json", default=None, metavar="PATH|JSON",
                   help="start from a Strategy JSON (file path or inline)")
    for cls, f, meta in _cli_fields():
        flag = meta["flag"]
        choices = meta["choices"]() if meta.get("choices") else None
        kw = dict(default=argparse.SUPPRESS, help=meta["help"],
                  dest="strategy_" + meta["legacy"])
        if f.type in ("bool", bool) or isinstance(f.default, bool):
            # boolean fields get a --x/--no-x pair so a preset/JSON base
            # can be overridden in BOTH directions (the legacy spelling
            # --no-error-feedback is the auto-generated negation)
            kw["action"] = argparse.BooleanOptionalAction
        else:
            kw["type"] = type(f.default)
            if choices:
                kw["choices"] = choices
            else:
                kw["metavar"] = meta["legacy"].upper()
        g.add_argument(flag, **kw)


def strategy_from_args(
        args: argparse.Namespace,
        worker_axes: Optional[Tuple[str, ...]] = None) -> Strategy:
    """Resolve the parsed flags into a validated `Strategy`:
    defaults ← preset/JSON base ← explicit flags ← `worker_axes`."""
    base = Strategy()
    if getattr(args, "preset", None) and getattr(args, "strategy_json",
                                                 None):
        raise SystemExit("--preset and --strategy-json are exclusive")
    if getattr(args, "preset", None):
        base = get_preset(args.preset)
    elif getattr(args, "strategy_json", None):
        spec = args.strategy_json
        if os.path.exists(spec):
            with open(spec) as fh:
                spec = fh.read()
        base = Strategy.from_json(spec)
    overrides = {}
    for _, f, meta in _cli_fields():
        dest = "strategy_" + meta["legacy"]
        if hasattr(args, dest):
            overrides[meta["legacy"]] = getattr(args, dest)
    # switching a kind resets its companion fields unless they were also
    # given explicitly — otherwise a preset's k/tau/budget would survive
    # onto a schedule/plan they are invalid for (e.g.
    # `--preset low_bandwidth --schedule every_step` with the preset's K=4)
    if overrides.get("schedule", base.schedule.kind) != base.schedule.kind:
        overrides.setdefault("local_k", 1)
        overrides.setdefault("staleness_tau", 1)
    new_plan = overrides.get("comm_plan", base.compression.plan)
    if new_plan != base.compression.plan and new_plan != "delta_budget":
        overrides.setdefault("comm_budget_mb", 0.0)
        overrides.setdefault("comm_adaptive", False)
    if worker_axes is not None:
        overrides["worker_axes"] = tuple(worker_axes)
    return base.evolve(**overrides)
