"""Shared argparse plumbing for the ``python -m repro_torch.obs``
subcommands (a copy of `repro.obs.cli`).

Both subcommands (report, calibrate) speak the same IO contract:

* positional sink file(s) written by ``--obs-sink PATH``;
* ``--json``   — print the computed payload as JSON instead of text;
* ``--out P``  — additionally write that JSON payload to P;
* ``--no-validate`` — skip schema validation when reading.

`obs.__main__` mounts each subcommand's ``add_args``/``run`` pair on
one subparser tree; the standalone ``main()`` entry points build the
same parser for direct module invocation. This module holds the shared
pieces so neither CLI re-spells the contract.
"""
from __future__ import annotations

import argparse
import json
from typing import List

from repro_torch.obs.sink import read_events


def add_io_args(ap: argparse.ArgumentParser, out_help: str) -> None:
    """The shared --json/--out/--no-validate trio."""
    ap.add_argument("--json", action="store_true",
                    help="print the computed payload as JSON instead of "
                         "the text rendering")
    ap.add_argument("--out", default="", metavar="PATH", help=out_help)
    ap.add_argument("--no-validate", action="store_true",
                    help="skip schema validation when reading")


def read_paths(paths: List[str], validate: bool) -> List[dict]:
    """Concatenate the events of one or more sink files."""
    events: List[dict] = []
    for p in paths:
        events.extend(read_events(p, validate=validate))
    return events


def emit(args: argparse.Namespace, payload: dict, text: str) -> None:
    """Honor the IO contract: --out writes the JSON payload; stdout gets
    JSON under --json, else the text rendering."""
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")
    print(json.dumps(payload, indent=2) if args.json else text)
