"""repro_torch.strategy — the typed, composable distribution-strategy API
(counterpart of `repro.strategy`, DESIGN.md §9).

A `Strategy` composes five frozen components — `Compression` (what goes
on the wire), `ExchangePlan` (how it moves), `Schedule` (when workers
talk), `Participation` (who talks) and `Observability` (what we measure
while they do) — with cross-field validation at
construction (`StrategyError`), a preset registry (`PRESETS`,
`get_preset`) and an exact canonical-JSON round-trip
(`Strategy.to_json`/`from_json`, hashed by `short_hash()` for the CI
regression gate and the checkpoint resume guard).

`core.dqgan.DQGAN` consumes a `Strategy` (directly, or via
`configs.base.DQConfig`); `strategy.cli` generates `launch.train`'s flag
surface from the component schemas.
"""
from .cli import add_strategy_args, strategy_from_args  # noqa: F401
from .components import (  # noqa: F401
    METRIC_LEVELS,
    SPMD_STYLES,
    Compression,
    ExchangePlan,
    MomentCompression,
    Observability,
    Participation,
    Schedule,
    StrategyError,
)
from .presets import (  # noqa: F401
    PRESET_DOCS,
    PRESETS,
    get_preset,
    register_preset,
)
from .strategy import LEGACY_FIELDS, Strategy  # noqa: F401
