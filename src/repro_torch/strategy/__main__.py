"""Preset-instantiation smoke: ``python -m repro_torch.strategy`` (the
counterpart of ``python -m repro.strategy``, whose output it repeats byte
for byte).

Constructs every registry preset, asserts the exact JSON round-trip, and
prints one line per preset (name, structural hash, description), so a
broken preset or a schema drift fails fast. ``--json NAME`` dumps one preset's JSON;
``--list-presets`` prints name + one-line doc + structural hash.
"""
from __future__ import annotations

import argparse
import sys

from .presets import PRESET_DOCS
from . import PRESETS, Strategy, get_preset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.strategy")
    ap.add_argument("--json", metavar="NAME", default="",
                    help="print one preset's canonical JSON and exit")
    ap.add_argument("--list-presets", action="store_true",
                    help="print name, one-line description and structural "
                         "hash for every registry preset")
    args = ap.parse_args(argv)
    if args.json:
        print(get_preset(args.json).to_json())
        return 0
    if args.list_presets:
        for name in sorted(PRESETS):
            st = PRESETS[name]
            doc = PRESET_DOCS.get(name, st.describe())
            print(f"{name:24s} {st.short_hash()}  {doc}")
        return 0
    bad = 0
    for name in sorted(PRESETS):
        st = PRESETS[name]
        back = Strategy.from_json(st.to_json())
        ok = back == st and back.to_json() == st.to_json()
        bad += not ok
        print(f"{name:24s} {st.short_hash()} "
              f"{'ok ' if ok else 'ROUND-TRIP MISMATCH '}{st.describe()}")
    print(f"{len(PRESETS)} presets, {bad} failures")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
