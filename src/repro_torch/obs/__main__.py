"""``python -m repro_torch.obs {report,calibrate}`` — the run-sink CLIs
(a copy of `repro.obs.__main__`).

One argparse subparser tree; each subcommand contributes its arguments
via its ``add_args`` hook and runs via its ``run`` hook, and both share
the ``--json`` / ``--out`` / ``--no-validate`` IO contract
(`repro_torch.obs.cli`).
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.obs import calibrate, report
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="run-sink observability CLIs (DESIGN.md §11-§13)")
    sub = ap.add_subparsers(dest="subcommand", metavar="SUBCOMMAND")
    for name, mod in (("report", report), ("calibrate", calibrate)):
        p = sub.add_parser(name, help=mod.DESCRIPTION,
                           description=mod.DESCRIPTION)
        mod.add_args(p)
        p.set_defaults(func=mod.run)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    func = getattr(args, "func", None)
    if func is None:
        ap.print_help()
        return 2
    return func(args)


if __name__ == "__main__":
    raise SystemExit(main())
