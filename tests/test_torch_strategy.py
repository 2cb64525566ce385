"""Port parity: `repro_torch.strategy` against `repro.strategy`. The schema
is the same, so the canonical JSON and its hash must be byte-identical:
checkpoints and baselines keyed by `short_hash()` stay valid across the two
packages."""
import argparse
import dataclasses

import pytest

from repro import strategy as JS
from repro.configs.base import DQConfig as JDQ
from repro_torch import strategy as TS
from repro_torch.configs.base import DQConfig as TDQ
from torch_ranks import one_thread  # noqa: F401 (autouse)

PRESETS = sorted(JS.PRESETS)


def test_same_presets():
    assert sorted(TS.PRESETS) == PRESETS
    assert TS.PRESET_DOCS == JS.PRESET_DOCS


@pytest.mark.parametrize("name", PRESETS)
def test_preset_json_hash_and_description(name):
    j, t = JS.get_preset(name), TS.get_preset(name)
    assert t.to_json() == j.to_json()
    assert t.short_hash() == j.short_hash()
    assert t.describe() == j.describe()
    assert t.legacy_fields() == j.legacy_fields()


@pytest.mark.parametrize("name", PRESETS)
def test_json_round_trip_across_packages(name):
    j = JS.get_preset(name)
    t = TS.Strategy.from_json(j.to_json())
    assert t == TS.get_preset(name)
    assert JS.Strategy.from_json(t.to_json()) == j
    assert TS.Strategy.from_json(t.to_json()) == t


def test_component_schemas_equal():
    for jc, tc in [(JS.Compression, TS.Compression),
                   (JS.ExchangePlan, TS.ExchangePlan),
                   (JS.Schedule, TS.Schedule),
                   (JS.Participation, TS.Participation),
                   (JS.MomentCompression, TS.MomentCompression),
                   (JS.Observability, TS.Observability)]:
        fj = [(f.name, f.default, dict(f.metadata).get("flag"))
              for f in dataclasses.fields(jc)]
        ft = [(f.name, f.default, dict(f.metadata).get("flag"))
              for f in dataclasses.fields(tc)]
        assert ft == fj, jc.__name__


@pytest.mark.parametrize("bad", [
    {"compression": {"compressor": "nope"}},
    {"compression": {"ef_dtype": "int8"}},
    {"compression": {"plan": "delta_budget"}},
    {"exchange": {"kind": "exact", "overlap": True}},
    {"exchange": {"spmd": "vmap", "kind": "two_phase"}},
    {"schedule": {"kind": "every_step", "k": 3}},
    {"participation": {"fraction": 0.0}},
    {"moments": {"compressor": "qsgd8_linf"}},
    {"observability": {"metrics": "loud"}},
    {"compression": {"error_feedback": False},
     "observability": {"metrics": "wire"}},
])
def test_invalid_strategies_refused_by_both(bad):
    with pytest.raises(JS.StrategyError):
        JS.Strategy.from_dict(bad)
    with pytest.raises(TS.StrategyError):
        TS.Strategy.from_dict(bad)


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "byte_budget"],
    ["--compressor", "qsgd8_block1024", "--comm-plan", "uniform"],
    ["--preset", "low_bandwidth", "--schedule", "every_step"],
    ["--strategy-json", '{"schedule": {"kind": "delayed", "tau": 4}}'],
    ["--no-error-feedback", "--exchange", "two_phase"],
])
def test_cli_flags_resolve_to_the_same_strategy(argv):
    aj, at = argparse.ArgumentParser(), argparse.ArgumentParser()
    JS.add_strategy_args(aj)
    TS.add_strategy_args(at)
    sj = JS.strategy_from_args(aj.parse_args(argv), worker_axes=())
    st = TS.strategy_from_args(at.parse_args(argv), worker_axes=())
    assert st.to_json() == sj.to_json()


def test_dqconfig_mirror():
    strat = TS.get_preset("byte_budget")
    t = TDQ.from_strategy(strat, optimizer="omd", lr=1e-3)
    j = JDQ.from_strategy(JS.get_preset("byte_budget"), optimizer="omd",
                          lr=1e-3)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.strategy == strat
    with pytest.raises(ValueError, match="strategy fields"):
        TDQ.from_strategy(strat, compressor="identity")


@pytest.mark.parametrize("argv", [[], ["--list-presets"]]
                         + [["--json", name] for name in PRESETS])
def test_main_prints_the_same_bytes(argv, capsys):
    """`python -m repro_torch.strategy` repeats `python -m repro.strategy`
    byte for byte: names, docs, short_hash() and the JSON of each
    preset."""
    from repro.strategy.__main__ import main as jmain
    from repro_torch.strategy.__main__ import main as tmain
    assert jmain(list(argv)) == 0
    want = capsys.readouterr().out
    assert tmain(list(argv)) == 0
    assert capsys.readouterr().out == want
    assert want.strip()
