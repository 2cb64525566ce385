"""repro_torch.sched — the execution-schedule runtime (counterpart of
`repro.sched`). Ported so far: count-exact partial participation
(`participation.py`). The schedules, the versioned server, the straggler
profiles and the wall clock arrive with ROADMAP §A slice 3.
"""
from .participation import (  # noqa: F401
    host_round_participants,
    n_participants,
    round_count,
    round_mask,
)
