"""Streaming SharesSkew on PyTorch: online micro-batch joins with
drift-triggered replanning (DESIGN.md §6; fused ingest hot path: §7;
bounded state: §8) — the port of ``repro.stream``.

  * ``sketch``    — decaying Count-Min + SpaceSaving heavy-hitter tracking
  * ``drift``     — cost-model staleness checks for the running plan
  * ``engine``    — stateful executor with carried reducer state; with
    ``StreamConfig(fused_ingest=True)`` the per-batch hot path runs
    through the ``kernels.ingest_fused`` CUDA pass
  * ``delta``     — sorted merge-join evaluation of the incremental-join
    terms for binary single-column joins (the fused path's delta engine)
  * ``retention`` — windowed/TTL expiry of carried state with exact
    window-fingerprint retraction
  * ``admission`` — backpressure: budgeted admission, FIFO backlog,
    explicit shedding with exact counters
  * ``recovery``  — reducer-loss recovery: host placement + heartbeat
    detection, lineage replay of lost reducer state, plan repair onto
    survivors, elastic degraded mode (DESIGN.md §5)
  * ``tenancy``   — N queries behind one ingest: a shared Count-Min pass
    on the card, per-query circuit breakers, fair-share shedding,
    namespaced checkpoints (DESIGN.md §9)

The engine checkpoints through ``repro_torch.train.checkpoint`` and takes
its host faults from ``repro_torch.testing.faults``.
"""
from repro_torch.obs import Observability, ObsPolicy  # noqa: F401  (re-export)

from .admission import (
    AdmissionController,
    AdmissionDecision,
    AdmissionPolicy,
    FairShareController,
    replication_width,
    weighted_fair_allocation,
)
from .drift import DriftDecision, DriftMonitor, plan_comm_on_batch, predicted_loads
from .engine import BatchReport, StreamConfig, StreamingJoinEngine
from .recovery import (
    HostTracker,
    RecoveryExhaustedError,
    RecoveryPolicy,
    RecoveryReport,
)
from .retention import (
    RetentionPolicy,
    carried_tuples,
    lost_occupancy,
    remove_prefix,
    select_reducers,
    zero_reducers,
)
from .sketch import (
    DecayingCountMin,
    HHSnapshot,
    SpaceSaving,
    StreamHHTracker,
    cms_delta,
)
from .tenancy import (
    DEGRADED,
    FAILED,
    QUARANTINED,
    RUNNING,
    MultiQueryEngine,
    TenancyPolicy,
    TenantSpec,
    TenantStatus,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionPolicy",
    "BatchReport",
    "DEGRADED",
    "FAILED",
    "FairShareController",
    "MultiQueryEngine",
    "Observability",
    "ObsPolicy",
    "QUARANTINED",
    "RUNNING",
    "TenancyPolicy",
    "TenantSpec",
    "TenantStatus",
    "DecayingCountMin",
    "DriftDecision",
    "DriftMonitor",
    "HHSnapshot",
    "HostTracker",
    "RecoveryExhaustedError",
    "RecoveryPolicy",
    "RecoveryReport",
    "RetentionPolicy",
    "SpaceSaving",
    "StreamConfig",
    "StreamingJoinEngine",
    "StreamHHTracker",
    "carried_tuples",
    "cms_delta",
    "lost_occupancy",
    "plan_comm_on_batch",
    "predicted_loads",
    "remove_prefix",
    "replication_width",
    "select_reducers",
    "weighted_fair_allocation",
    "zero_reducers",
]
