"""The benchmark's data, found by name: the cell in `BENCHMARK.json`, its
configuration (`bench/configs/<config>.json`), its traffic
(`bench/workloads/<traffic>.json`), its correctness limits
(`bench/limits/<cell>.json`) and the peaks (`bench/peaks.json`)."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _read(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic file
    limits: dict        # {number: {"limit": x, ...}}
    end_to_end: list    # the BENCHMARK.json metric entries this cell reports
    per_layer: list
    peaks: dict


# every key of a traffic file, and of its "strategy", is read by the
# harness; a file with another is refused rather than run as if it were not
# there
TRAFFIC_KEYS = {"about", "batch", "seq", "batches", "checked_steps",
                "profile_steps", "strategy"}
STRATEGY_KEYS = {"optimizer", "message", "lr", "compressor", "plan",
                 "bucket_mb", "levels"}


def check_traffic(name: str, traffic: dict) -> dict:
    """`traffic` where it has the harness's keys and no other."""
    for keys, got, where in ((TRAFFIC_KEYS, set(traffic), "traffic"),
                             (STRATEGY_KEYS, set(traffic.get("strategy", {})),
                              "strategy")):
        if got != keys:
            raise SystemExit(f"bench: {where} of {name!r}: keys "
                             f"{sorted(got - keys)} are read by nothing, "
                             f"{sorted(keys - got)} are missing")
    return traffic


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    if int(w["chips"]) != 1:
        raise SystemExit(f"bench: {name} asks for {w['chips']} chips; the "
                         f"harness runs one worker on one card")
    here = root / "bench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read(here / "configs" / f"{w['config']}.json"),
        traffic=check_traffic(w["traffic"], _read(
            here / "workloads" / f"{w['traffic']}.json")),
        limits=_read(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        peaks=_read(here / "peaks.json"))


def model_config(cfg_file: dict):
    """The port's `ModelConfig` of a configuration file's "model" object;
    a nested group becomes its sub-config."""
    from repro_torch.configs import base
    groups = {"ssm": base.SSMConfig, "moe": base.MoEConfig,
              "rglru": base.RGLRUConfig, "encdec": base.EncDecConfig}
    m = dict(cfg_file["model"])
    for k, cls in groups.items():
        if m.get(k) is not None:
            m[k] = cls(**m[k])
    if "layer_pattern" in m:
        m["layer_pattern"] = tuple(m["layer_pattern"])
    return base.ModelConfig(**m)


def strategy(traffic: dict, spans: bool):
    """The port's `DQConfig` of a traffic file's "strategy": one worker
    (several over a mesh), the compressor over its bucket plan, error
    feedback, and the observability spans on or off."""
    from repro_torch.configs import DQConfig
    from repro_torch.strategy import Compression, Observability, Strategy
    s = traffic["strategy"]
    strat = Strategy(
        compression=Compression(compressor=s["compressor"], plan=s["plan"],
                                bucket_mb=s["bucket_mb"]),
        observability=Observability(spans=spans))
    return DQConfig.from_strategy(strat, optimizer=s["optimizer"],
                                  lr=s["lr"], message=s["message"])
