"""repro_torch.sched — the execution-schedule runtime (counterpart of
`repro.sched`).

  schedule.py      : ExchangeSchedule — every_step | local_k | delayed(τ).
  server.py        : versioned parameter server — bounded-staleness
                     push/pull semantics + event-driven wall-clock sim.
  participation.py : count-exact partial worker participation per round,
                     with EF accumulation for the workers sitting out.
  straggler.py     : seeded per-worker heterogeneity profiles.
  clock.py         : simulated wall clock composing schedule dataflow,
                     straggler compute times and comm.ledger wire bytes.

Everything but `participation.round_mask`/`round_count` is host-side
numpy, copied from the JAX package. `core.dqgan` implements the in-step
dataflow of each schedule (state under `DQState.sched`, through the
`strategy.Schedule` component); `launch.train` drives the host-side
cadence and the simulated clock. `round_key` has no counterpart: the
round's mask comes from the trainer's generator (see participation.py).
"""
from .clock import (  # noqa: F401
    LinkModel,
    baseline_mean_step,
    simulate,
    speedup_vs_M,
    time_per_step,
)
from .participation import (  # noqa: F401
    host_round_participants,
    n_participants,
    round_count,
    round_mask,
)
from .schedule import (  # noqa: F401
    SCHEDULES,
    ExchangeSchedule,
    get,
    seeded_tau_vector,
)
from .server import (  # noqa: F401
    StalenessBoundExceeded,
    VersionedServer,
    simulate_push_pull,
)
from .straggler import (  # noqa: F401
    PROFILES,
    StragglerProfile,
    get_profile,
    step_times,
    worker_slowdowns,
)
