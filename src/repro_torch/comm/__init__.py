"""The communication subsystem (counterpart of `repro.comm`): flat
gradient buckets, the per-bucket compressor planner and the wire-byte
ledger. All host-side and static, except `pack`/`unpack_into`."""
from .buckets import (  # noqa: F401
    Bucket,
    BucketLayout,
    LeafSlot,
    build_layout,
    layout_for_params,
    pack,
    unpack_into,
)
from .ledger import (  # noqa: F401
    CommLedger,
    LedgerEntry,
    payload_nbytes,
    strategy_wire_bytes,
)
from .planner import (  # noqa: F401
    ALL_POLICIES,
    BucketAssignment,
    CommPlan,
    POLICIES,
    PlanFamily,
    analytic_delta,
    plan_comm,
    plan_family,
    quant_ladder,
)
