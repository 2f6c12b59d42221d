"""Reducer-loss recovery for the streaming engine (DESIGN.md §5).

In the port these are the policy, placement and report types only: the
port's engine does not run recovery yet and raises
``NotImplementedError`` when ``StreamConfig.recovery`` is enabled
(ROADMAP.md queue 1 item 8).  The design below is the reference's.

The shares assignment deliberately concentrates heavy-hitter work on
specific reducers — so losing the host that carries them loses exactly
the state that is most expensive to rebuild.  Before this subsystem the
only remedy was a full checkpoint restore (DESIGN.md §8); recovery
instead runs in-flight, at batch boundaries, through four stages:

  1. **detection** — logical reducers are multiplexed over simulated
     hosts (contiguous blocks, ``HostTracker``); every live host
     heartbeats once per ingested batch into a
     ``mapreduce.straggler.FailureDetector`` clocked in *batch indices*
     (deterministic under test), and a host ``deadline_batches`` behind
     is declared lost;
  2. **repair** — if the surviving fraction stays above
     ``degrade_below``, the incumbent plan is untouched (same grid, same
     HH combinations) and the lost logical reducers are simply remapped
     onto survivors; under sustained loss, ``core.planner.repair_plan``
     re-projects the incumbent shares onto a grid sized by
     ``train.elastic.plan_mesh_shape`` for the surviving hosts — HH
     combinations never move, each residual's grid shrinks in place;
  3. **replay** — the lost reducers' carried state is reconstructed by
     *lineage replay* from the retained per-batch window: each retained
     batch's routed emissions are filtered to the lost destinations and
     re-scattered in batch order, reproducing the dead bins
     bit-for-bit.  Replayed tuples == the lost reducers' retained-window
     share; nothing else moves — no full-stream re-route, no checkpoint
     read;
  4. **degrade** — in degraded mode admission budgets additionally
     tighten by the surviving-capacity fraction
     (``AdmissionController.set_capacity``), and when the survivors
     cannot host even one reducer per residual combination, recovery is
     *exhausted*: ``RecoveryExhaustedError`` — an explicit, loud error,
     never a silently wrong window.

Every recovery is verified exact on the spot: the recovered binned state
is re-joined through the einsum oracle and its (count, checksum) must
equal the maintained window fingerprint bit-for-bit (the same invariant
``recompute_distributed(window=True)`` checks externally).

Cost model (PAPERS.md, Beame–Koutris–Suciu arXiv:1401.1872): with L of K
reducers lost and per-relation window loads W_rel, lineage replay ships
``sum_rel (L/K) * W_rel`` tuples in one round — an L/K fraction of the
retained window — versus a full restore's ``sum_rel W_rel`` plus the
checkpoint read.  See DESIGN.md §5 for the derivation.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class RecoveryExhaustedError(RuntimeError):
    """Loss beyond the survivable grid: the remaining hosts cannot carry a
    correct repaired plan (fewer survivors than ``min_hosts``, or fewer
    reducer slots than residual combinations).  Raised at the failure
    boundary and again on any subsequent ``ingest`` — an exhausted engine
    refuses to produce answers rather than produce wrong ones."""


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Recovery knobs.  ``n_hosts=None`` (default) disables the host model
    entirely, reproducing the pre-recovery engine bit-for-bit."""

    n_hosts: int | None = None  # provisioned hosts reducers multiplex over
    deadline_batches: int = 1  # heartbeat deadline for the failure detector
    degrade_below: float = 0.5  # alive/provisioned below this -> repair+shrink
    min_hosts: int = 1  # fewer survivors than this -> recovery exhausted
    verify: bool = True  # re-join recovered state vs the window fingerprint
    hosts_per_pod: int = 256  # pod granularity for plan_mesh_shape

    def __post_init__(self):
        if self.n_hosts is not None and self.n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        if self.deadline_batches < 1:
            raise ValueError("deadline_batches must be >= 1")
        if not 0.0 <= self.degrade_below <= 1.0:
            raise ValueError("degrade_below must be in [0, 1]")
        if self.min_hosts < 1:
            raise ValueError("min_hosts must be >= 1")

    @property
    def enabled(self) -> bool:
        return self.n_hosts is not None


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """Telemetry for one recovery event (``engine.recoveries``)."""

    batch: int  # batch boundary the recovery ran at
    lost_hosts: tuple[int, ...]
    lost_reducers: int  # logical reducers whose state was unreachable
    mode: str  # "replay" (same plan) | "degrade" (repaired plan)
    survivors: int  # hosts alive after the loss
    batches_replayed: int  # retained batches walked by lineage replay
    replayed_tuples: int  # emissions re-scattered into lost bins
    lost_share_tuples: int  # the lost reducers' retained-window share
    #                         (replayed_tuples <= this, by construction)
    migrated_tuples: int  # degrade mode: emissions re-routed by the repair
    reducers_before: int  # plan.total_reducers before / after recovery
    reducers_after: int
    verified: bool  # recovered state re-joined == window fingerprint
    tenant: str = ""  # multi-tenant runs: which query this event repaired
    #                   ("" in single-tenant engines; MultiQueryEngine
    #                   relabels per-query events it aggregates)


def record_recovery(obs, report: RecoveryReport) -> None:
    """Fold one recovery event into the observability registry
    (DESIGN.md §10).  The facade injects the tenant label for tenant
    engines; ``NULL_OBS`` makes every call here free when metrics are off.
    Counter taxonomy: events by mode (replay vs degrade), lineage volume
    (replayed tuples vs the lost share they reconstruct), repair-migration
    volume, and a loud counter for failed verifications — which also raise,
    but a scrape must see them after the process survives."""
    if obs.tracer.enabled:
        obs.instant(
            "recovery.report", cat="recovery", args=dataclasses.asdict(report)
        )
    if not obs.metrics.enabled:
        return
    obs.counter("stream_recovery_total", mode=report.mode).inc()
    obs.counter("stream_recovery_lost_reducers_total").inc(report.lost_reducers)
    obs.counter("stream_recovery_replayed_tuples_total").inc(
        report.replayed_tuples
    )
    obs.counter("stream_recovery_lost_share_tuples_total").inc(
        report.lost_share_tuples
    )
    if report.migrated_tuples:
        obs.counter("stream_recovery_migrated_tuples_total").inc(
            report.migrated_tuples
        )
    if not report.verified:
        obs.counter("stream_recovery_verify_failures_total").inc()
    obs.gauge("stream_hosts_alive").set(report.survivors)


class HostTracker:
    """Placement + liveness bookkeeping for the simulated reducer hosts.

    Logical reducer ids are the unit of state (bins are indexed by them);
    hosts are where they live.  Assignment is contiguous blocks over the
    alive list, so host loss takes out a contiguous slab of reducer ids
    and every surviving reducer's state stays in place.  A host can be:
    alive (heartbeating), *silenced* (fault fired, heartbeats stopped,
    not yet declared — the detection gap), declared lost (out of the
    pool), or fenced-awaiting-heal (partition: rejoins empty later).
    """

    def __init__(self, policy: RecoveryPolicy):
        if not policy.enabled:
            raise ValueError("HostTracker requires RecoveryPolicy.n_hosts")
        self.policy = policy
        self.provisioned = int(policy.n_hosts)
        self.alive: list[int] = list(range(self.provisioned))
        # host -> heal-at batch (None = permanent loss), set when a fault
        # fires; the host stays in ``alive`` until the detector declares it
        self.silenced: dict[int, int | None] = {}
        # declared-lost partitions waiting to heal: host -> heal-at batch
        self.fenced: dict[int, int] = {}
        self.host_of: np.ndarray = np.zeros(0, dtype=np.int64)

    # ---- placement ---------------------------------------------------------
    def assign(self, total_reducers: int) -> None:
        """(Re)place all reducers in contiguous blocks over alive hosts —
        called at every plan install, mirroring the full state rebuild."""
        n = max(1, len(self.alive))
        self.host_of = np.array(
            [self.alive[(r * n) // max(1, total_reducers)]
             for r in range(total_reducers)],
            dtype=np.int64,
        )

    def reducers_on(self, hosts) -> np.ndarray:
        """Logical reducer ids currently placed on the given hosts."""
        hosts = np.asarray(list(hosts), dtype=np.int64)
        if self.host_of.size == 0 or hosts.size == 0:
            return np.zeros(0, dtype=np.int64)
        return np.flatnonzero(np.isin(self.host_of, hosts)).astype(np.int64)

    def reassign(self, lost: np.ndarray) -> None:
        """Spread the lost reducers round-robin over the surviving hosts
        (same-plan repair: only the lost ids move; survivors stay put)."""
        lost = np.asarray(lost, dtype=np.int64)
        if lost.size and self.alive:
            surv = np.asarray(self.alive, dtype=np.int64)
            self.host_of[lost] = surv[np.arange(lost.size) % surv.size]

    # ---- liveness ----------------------------------------------------------
    def silence(self, host: int, heal_at: int | None = None) -> None:
        """A fault fired on ``host``: its heartbeats stop (permanently for
        ``host_loss``, until ``heal_at`` for ``partition``)."""
        if host in self.alive:
            self.silenced[host] = heal_at

    def beating(self) -> list[int]:
        return [h for h in self.alive if h not in self.silenced]

    def declare_lost(self, hosts) -> None:
        """The detector declared these hosts dead: out of the pool.  A
        silenced-by-partition host is fenced — its state is stale (the
        pool recovered without it) and is discarded when it heals."""
        for h in hosts:
            if h not in self.alive:
                continue
            self.alive.remove(h)
            heal_at = self.silenced.pop(h, None)
            if heal_at is not None:
                self.fenced[h] = heal_at

    def heal_due(self, batch: int) -> list[int]:
        """Fenced hosts whose partition healed by ``batch``: they rejoin
        the pool as empty spares (their pre-partition state was fenced
        off; reducers land on them again at the next plan install)."""
        healed = sorted(h for h, at in self.fenced.items() if at <= batch)
        for h in healed:
            self.fenced.pop(h)
            self.alive.append(h)
        self.alive.sort()
        return healed

    # ---- checkpoint --------------------------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        sil = sorted(self.silenced.items())
        return {
            "alive": np.asarray(self.alive, dtype=np.int64),
            "silenced": np.asarray(
                [(h, -1 if at is None else at) for h, at in sil],
                dtype=np.int64,
            ).reshape(-1, 2),
            "fenced": np.asarray(
                sorted(self.fenced.items()), dtype=np.int64
            ).reshape(-1, 2),
            "host_of": self.host_of,
        }

    def load_state_dict(self, state) -> None:
        self.alive = [int(h) for h in np.asarray(state["alive"])]
        self.silenced = {
            int(h): (None if at < 0 else int(at))
            for h, at in np.asarray(state["silenced"]).reshape(-1, 2)
        }
        self.fenced = {
            int(h): int(at)
            for h, at in np.asarray(state["fenced"]).reshape(-1, 2)
        }
        self.host_of = np.asarray(state["host_of"]).astype(np.int64)
