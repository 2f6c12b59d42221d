"""Multi-tenant streaming joins: N queries, one ingest path (DESIGN.md §9),
the port of ``repro.stream.tenancy``.

A production deployment does not run one join query per process: many
concurrent queries watch the *same* relation streams, and the expensive
shared work — sketching the inflow for heavy hitters — is identical for
every query that shares a sketch configuration.  ``MultiQueryEngine`` runs
N ``StreamingJoinEngine``s behind one ingest call with three contracts:

  * **Shared sketch ingest.**  Count-Min increments are computed ONCE per
    relation batch per sketch signature (width, depth, seed) and absorbed
    by every eligible tenant (``ingest(..., shared_deltas=...)``).  The
    pass is the Count-Min kernel (``kernels.sketch_update.cms_update``) on
    the engine's device, one launch per (attr, relation) column, widened
    to float64: the same table as ``sketch.cms_delta`` on the host.
    Integer counts are exact in float64, so the
    absorbed tables are bit-identical to a private pass; a tenant whose
    admitted rows differ from the shared batch (backlog, shedding, a
    tampered view) silently falls back to a private pass — correctness
    never depends on the sharing.  ``shared_sketch_passes`` /
    ``engine.sketch_ingest_calls`` count both sides of that contract.
  * **Blast-radius containment.**  Every tenant ingests inside a per-query
    circuit breaker.  A poison batch (``engine._validate_batch`` raises
    before any state mutation) trips the breaker: the victim is
    ``QUARANTINED`` for an exponentially growing backoff
    (``base * 2^(failures-1)`` batches), re-opened at most
    ``max_reopens`` times, then ``FAILED`` permanently — as it is
    immediately on ``RecoveryExhaustedError``.  A query whose recovery
    degraded its plan serves on as ``DEGRADED``.  Neighbors never see any
    of it: their engines are separate objects fed pristine views, so their
    cumulative fingerprints stay bit-identical to single-tenant runs (the
    isolation proof in ``tests/test_tenancy.py``).
  * **Fair-share overload control.**  Per batch, each tenant's demand is
    its offered rows weighted by its live plan's replication width (the
    Beame–Koutris–Suciu communication budget: what it will actually
    ship).  When aggregate demand exceeds ``TenancyPolicy.capacity``, the
    weighted max-min allocation (``admission.weighted_fair_allocation``)
    trims ONLY tenants over their fair share — trimmed rows are shed at
    the door with exact per-tenant counters (``overload_shed``,
    ``backpressure``) and the offender's own FIFO admission sees the rest.

Host faults route through the same recovery subsystem as single-tenant
engines, scoped per query: each tenant's engine has its own ``HostTracker``
and lineage, so a tenant-targeted ``host_loss`` replays/degrades the
victim alone.  Checkpoints are per-tenant namespaced directories
(``train.checkpoint.tenant_checkpoint_dir``) plus one control namespace
for breaker and fair-share state — kill → resume is bit-identical for
every tenant.  The checkpoints keep the JAX package's layout, keys and
class names, so either package restores the other's.

``device`` (default ``"cuda"``, raising without a card) is where every
tenant engine and the shared pass run; ``device="cpu"`` runs the kernels'
plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.schema import JoinQuery
from repro_torch.kernels.sketch_update import cms_update
from repro_torch.mapreduce.executor import _device
from repro_torch.obs import Observability, ObsPolicy
from repro_torch.testing.faults import FaultInjector
from repro_torch.train.checkpoint import (
    load_checkpoint,
    load_manifest,
    save_checkpoint as _save,
    tenant_checkpoint_dir,
)

from .admission import FairShareController, replication_width
from .engine import BatchReport, StreamConfig, StreamingJoinEngine
from .recovery import RecoveryExhaustedError

# tenant lifecycle states
RUNNING = "RUNNING"
QUARANTINED = "QUARANTINED"  # breaker open; ingest skipped until reopen
DEGRADED = "DEGRADED"  # serving, but on a repaired (shrunk) plan
FAILED = "FAILED"  # breaker exhausted or recovery exhausted; terminal

_CONTROL = "__control__"  # reserved checkpoint namespace (not a tenant)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One query's identity, plan inputs, and fair-share weight."""

    name: str
    query: JoinQuery
    config: StreamConfig
    weight: float = 1.0

    def __post_init__(self):
        if not self.name or not all(
            c.isalnum() or c in "-_." for c in self.name
        ):
            raise ValueError(
                f"tenant name {self.name!r} must be a filename-safe token"
            )
        if self.name == _CONTROL:
            raise ValueError(f"tenant name {_CONTROL!r} is reserved")
        if not (self.weight > 0 and np.isfinite(self.weight)):
            raise ValueError(f"tenant weight must be finite > 0, got {self.weight}")


@dataclasses.dataclass(frozen=True)
class TenancyPolicy:
    """Engine-wide knobs (defaults: no aggregate cap, 3 reopens)."""

    capacity: float | None = None  # aggregate predicted arrivals per batch
    #                                (None = no cross-tenant shedding)
    breaker_backoff: int = 1  # quarantine length after the 1st failure
    #                           (doubles per consecutive failure)
    breaker_max_reopens: int = 3  # reopen attempts before FAILED
    # Observability (DESIGN.md §10): ONE tracer + metrics registry shared
    # by all tenants; each tenant engine gets a label-injecting view, so
    # the same metric name yields per-tenant isolated series.  A tenant's
    # own ``StreamConfig.obs`` is ignored under a MultiQueryEngine — the
    # shared facade wins (injected obs takes precedence in the engine).
    obs: ObsPolicy = ObsPolicy()

    def __post_init__(self):
        if self.breaker_backoff < 1:
            raise ValueError("breaker_backoff must be >= 1 batch")
        if self.breaker_max_reopens < 0:
            raise ValueError("breaker_max_reopens must be >= 0")


@dataclasses.dataclass(frozen=True)
class TenantStatus:
    """Externally visible snapshot of one tenant's breaker."""

    name: str
    state: str
    failures: int  # consecutive breaker trips (resets on a good batch)
    reopens: int  # reopen attempts consumed (never resets)
    quarantined_until: int  # shared batch index at which the breaker half-opens
    last_error: str


class _Tenant:
    """Runtime record: spec + engine + circuit breaker."""

    def __init__(self, spec: TenantSpec, engine: StreamingJoinEngine):
        self.spec = spec
        self.engine = engine
        self.state = RUNNING
        self.failures = 0
        self.reopens = 0
        self.quarantined_until = 0
        self.last_error = ""

    def status(self) -> TenantStatus:
        return TenantStatus(
            name=self.spec.name,
            state=self.state,
            failures=self.failures,
            reopens=self.reopens,
            quarantined_until=self.quarantined_until,
            last_error=self.last_error,
        )


def _kernel_keys(col: np.ndarray) -> torch.Tensor | None:
    """One shared column as the Count-Min kernel's int32 keys, as
    ``sketch.cms_delta`` reads it (cast to int64, so a float truncates);
    None where that cast is not exact in int32."""
    col = np.asarray(col)
    if not (np.issubdtype(col.dtype, np.integer) or np.issubdtype(col.dtype, np.floating)):
        return None
    if np.issubdtype(col.dtype, np.floating) and not np.isfinite(col).all():
        return None
    if col.size and (col.min() < -(2**31) or col.max() >= 2**31):
        return None
    return torch.from_numpy(np.ascontiguousarray(col.astype(np.int64).astype(np.int32)))


class MultiQueryEngine:
    """N concurrent join queries over shared relation streams."""

    def __init__(
        self,
        tenants: Iterable[TenantSpec],
        policy: TenancyPolicy = TenancyPolicy(),
        log_fn: Callable[[str], None] | None = None,
        clock: Callable[[], float] | None = None,
        device: str | torch.device = "cuda",
    ):
        specs = list(tenants)
        if not specs:
            raise ValueError("MultiQueryEngine needs at least one tenant")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        self.policy = policy
        self.device = _device(device)
        self._log = log_fn or (lambda _msg: None)
        self.obs = Observability(policy.obs)  # shared tracer + registry
        self._tenants: dict[str, _Tenant] = {}
        for spec in specs:
            engine = StreamingJoinEngine(
                spec.query,
                spec.config,
                log_fn=log_fn,
                clock=clock,
                device=self.device,
                obs=self.obs.for_tenant(
                    spec.name,
                    arities={r.name: r.arity for r in spec.query.relations},
                ),
            )
            engine.tenant = spec.name
            self._tenants[spec.name] = _Tenant(spec, engine)
        self.fair = FairShareController(
            policy.capacity, {s.name: s.weight for s in specs}
        )
        self._injector = None
        self.batches = 0  # shared batch clock (absolute index)
        # sketch sharing: one pass per relation batch per sketch signature
        self.shared_sketch_passes = 0  # (attr, rel) column passes computed
        self._sketch_groups = self._group_sketches()

    # ---- shared sketch ingest ----------------------------------------------
    def _group_sketches(self) -> list[tuple[tuple[int, ...], int, list[str], dict]]:
        """Group tenants by CMS signature (seeds, width): one shared pass
        per group covers the union of its members' (attr, rel) columns."""
        groups: dict[tuple, dict] = {}
        for t in self._tenants.values():
            tr = t.engine.tracker
            key = (tr.seeds, tr.width)
            g = groups.setdefault(key, {"members": [], "cols": {}})
            g["members"].append(t.spec.name)
            for a in tr.attrs:
                for rel in t.spec.query.relations_of(a):
                    g["cols"][(a, rel.name)] = rel.index_of(a)
        return [
            (seeds, width, g["members"], g["cols"])
            for (seeds, width), g in sorted(
                groups.items(), key=lambda kv: kv[1]["members"]
            )
        ]

    def _shared_deltas(
        self, batch: Mapping[str, np.ndarray]
    ) -> dict[str, dict[tuple[str, str], np.ndarray]]:
        """The once-per-relation-batch sketch pass: per tenant name, the
        delta dict its engine can absorb (same object shared across the
        group — computed once, never mutated by absorb).  A column the
        Count-Min kernel cannot take (not numeric, not finite, outside
        int32) is skipped, neither computed nor counted: every tenant that
        reads it rejects the batch in ``_validate_batch``."""
        per_tenant: dict[str, dict[tuple[str, str], np.ndarray]] = {}
        for seeds, width, members, cols in self._sketch_groups:
            deltas: dict[tuple[str, str], np.ndarray] = {}
            for (a, rel_name), col_idx in sorted(cols.items()):
                if rel_name not in batch:
                    continue
                rows = np.asarray(batch[rel_name])
                if rows.ndim != 2 or col_idx >= rows.shape[1]:
                    continue  # malformed shared batch; tenants will reject
                keys = _kernel_keys(rows[:, col_idx])
                if keys is None:
                    continue  # malformed shared batch; tenants will reject
                deltas[(a, rel_name)] = (
                    cms_update(keys.to(self.device), seeds, width)
                    .cpu().numpy().astype(np.float64)
                )
                self.shared_sketch_passes += 1
                if self.obs.metrics.enabled:
                    self.obs.counter("tenancy_shared_sketch_passes_total").inc()
            for name in members:
                per_tenant[name] = deltas
        return per_tenant

    # ---- fair share --------------------------------------------------------
    def _demand(self, t: _Tenant, view: Mapping[str, np.ndarray]) -> float:
        """Predicted reducer arrivals this tenant's view will generate:
        rows x replication width per relation (width 1 pre-plan)."""
        plan = t.engine.plan
        total = 0.0
        for rel in t.spec.query.relations:
            n = len(view.get(rel.name, ()))
            w = replication_width(plan, rel.name) if plan is not None else 1
            total += float(n) * w
        return total

    @staticmethod
    def _trim(
        view: dict[str, np.ndarray], fraction: float
    ) -> tuple[dict[str, np.ndarray], int]:
        """Keep the FIFO prefix of ``fraction`` of each relation's rows;
        returns (trimmed view, rows dropped)."""
        if fraction >= 1.0:
            return view, 0
        out, dropped = {}, 0
        for nm, rows in view.items():
            rows = np.asarray(rows)
            keep = int(np.floor(rows.shape[0] * fraction))
            out[nm] = rows[:keep]
            dropped += rows.shape[0] - keep
        return out, dropped

    # ---- circuit breaker ---------------------------------------------------
    def _state_event(self, name: str, to_state: str, bid: int) -> None:
        """One breaker/lifecycle transition into the shared registry + trace
        (DESIGN.md §10).  Labeled (tenant, to), so a scrape sees each
        tenant's transition history as its own series."""
        if self.obs.metrics.enabled:
            self.obs.counter(
                "tenancy_breaker_transitions_total", tenant=name, to=to_state
            ).inc()
        if self.obs.tracer.enabled:
            self.obs.instant(
                "tenant.state",
                cat="tenancy",
                args={"tenant": name, "to": to_state, "batch": bid},
            )

    def _trip(self, t: _Tenant, bid: int, err: BaseException) -> None:
        """One breaker trip: quarantine with exponential backoff, or FAIL
        permanently once the reopen budget is spent."""
        t.failures += 1
        t.last_error = f"{type(err).__name__}: {err}"
        if t.reopens >= self.policy.breaker_max_reopens:
            t.state = FAILED
            self._state_event(t.spec.name, FAILED, bid)
            self._log(
                f"[tenancy] {t.spec.name} FAILED at batch {bid}: reopen "
                f"budget spent after {t.failures} failure(s) ({t.last_error})"
            )
            return
        backoff = self.policy.breaker_backoff * (2 ** (t.failures - 1))
        t.state = QUARANTINED
        t.quarantined_until = bid + 1 + backoff
        self._state_event(t.spec.name, QUARANTINED, bid)
        self._log(
            f"[tenancy] {t.spec.name} QUARANTINED at batch {bid} for "
            f"{backoff} batch(es) ({t.last_error})"
        )

    def _maybe_reopen(self, t: _Tenant, bid: int) -> None:
        if t.state == QUARANTINED and bid >= t.quarantined_until:
            t.reopens += 1
            t.state = RUNNING
            self._state_event(t.spec.name, RUNNING, bid)
            self._log(
                f"[tenancy] {t.spec.name} breaker half-open at batch {bid} "
                f"(reopen {t.reopens}/{self.policy.breaker_max_reopens})"
            )

    # ---- ingest ------------------------------------------------------------
    def ingest(
        self, batch: Mapping[str, np.ndarray]
    ) -> dict[str, BatchReport | None]:
        """One shared micro-batch through every serving tenant.

        Returns per tenant: its ``BatchReport``, or ``None`` when the
        tenant did not serve this batch (quarantined, failed, or tripped
        on it).  The shared batch object is never mutated — every tenant
        reads its own view.
        """
        bid = self.batches
        for t in self._tenants.values():
            self._maybe_reopen(t, bid)
        serving = [
            t
            for t in self._tenants.values()
            if t.state in (RUNNING, DEGRADED)
        ]

        # per-tenant views: restriction to the query's relations, then
        # tenant-targeted fault tampering (victim's view only)
        views: dict[str, dict[str, np.ndarray]] = {}
        events: dict[str, list] = {}
        clean: dict[str, bool] = {}
        for t in serving:
            nm = t.spec.name
            view = {
                r.name: batch[r.name]
                for r in t.spec.query.relations
                if r.name in batch
            }
            clean[nm] = True
            events[nm] = []
            if self._injector is not None:
                view, evs = self._injector.apply_tenant_faults(bid, nm, view)
                if evs:
                    events[nm] = evs
                    clean[nm] = False
            views[nm] = view

        # fair-share overload control over the (possibly inflated) demand
        demands = {t.spec.name: self._demand(t, views[t.spec.name]) for t in serving}
        fractions = self.fair.fractions(demands)
        for t in serving:
            nm = t.spec.name
            views[nm], dropped = self._trim(views[nm], fractions.get(nm, 1.0))
            if self.obs.metrics.enabled:
                self.obs.gauge("tenancy_fair_fraction", tenant=nm).set(
                    fractions.get(nm, 1.0)
                )
                self.obs.gauge("tenancy_demand_rows", tenant=nm).set(
                    demands.get(nm, 0.0)
                )
            if dropped:
                self.fair.record_trim(nm, dropped)
                clean[nm] = False  # admitted view != shared batch
                if self.obs.metrics.enabled:
                    self.obs.counter(
                        "tenancy_overload_shed_rows_total", tenant=nm
                    ).inc(dropped)
                self._log(
                    f"[tenancy] {nm} overload-shed {dropped} row(s) at "
                    f"batch {bid} (fair share {fractions[nm]:.3f})"
                )

        # the ONE shared sketch pass per relation batch
        shared = self._shared_deltas(batch)

        out: dict[str, BatchReport | None] = {
            name: None for name in self._tenants
        }
        for t in serving:
            nm = t.spec.name
            try:
                out[nm] = t.engine.ingest(
                    views[nm],
                    shared_deltas=shared.get(nm) if clean[nm] else None,
                )
                if t.failures:
                    t.failures = 0  # breaker closes on a good batch
                if t.state == RUNNING and any(
                    r.mode == "degrade" for r in t.engine.recoveries
                ):
                    t.state = DEGRADED
                    self._state_event(nm, DEGRADED, bid)
            except RecoveryExhaustedError as err:
                t.state = FAILED
                t.last_error = f"{type(err).__name__}: {err}"
                self._state_event(nm, FAILED, bid)
                self._log(
                    f"[tenancy] {nm} FAILED at batch {bid}: {t.last_error}"
                )
            except Exception as err:  # poison pill / schema mismatch
                self._trip(t, bid, err)
            # tenant-targeted events are contained iff the engine either
            # served the tampered view with exact counters (overload) or
            # the breaker took the victim out (poison)
            for ev in events[nm]:
                if ev.spec.kind == "tenant_overload":
                    contained = out[nm] is not None or t.state in (
                        QUARANTINED,
                        FAILED,
                    )
                else:  # poison_rows: containment == the breaker acted
                    contained = out[nm] is None and t.state in (
                        QUARANTINED,
                        FAILED,
                    )
                FaultInjector.mark_tenant_event(ev, contained)
        self.batches += 1
        return out

    # ---- faults / recovery -------------------------------------------------
    def arm_faults(self, injector) -> None:
        """Attach one ``FaultInjector`` for every seam: tenant-targeted
        batch tampering here, host faults inside each tenant's engine
        (scoped by ``engine.tenant``, so a targeted loss fires only in the
        victim's recovery domain)."""
        self._injector = injector
        for t in self._tenants.values():
            t.engine.arm_faults(injector)

    def fail_hosts(self, tenant: str, hosts_to_kill):
        """Operational host kill inside ONE tenant's recovery domain; a
        recovery-exhausted victim is contained as FAILED instead of
        propagating (the neighbors keep serving).  Returns the victim's
        ``RecoveryReport`` (None if nothing recovered or the tenant
        failed)."""
        t = self._tenant(tenant)
        try:
            report = t.engine.fail_hosts(hosts_to_kill)
            if t.state == RUNNING and any(
                r.mode == "degrade" for r in t.engine.recoveries
            ):
                t.state = DEGRADED
                self._state_event(tenant, DEGRADED, self.batches)
            return report
        except RecoveryExhaustedError as err:
            t.state = FAILED
            t.last_error = f"{type(err).__name__}: {err}"
            self._state_event(tenant, FAILED, self.batches)
            self._log(f"[tenancy] {tenant} FAILED on host kill: {t.last_error}")
            return None

    # ---- introspection -----------------------------------------------------
    def _tenant(self, name: str) -> _Tenant:
        if name not in self._tenants:
            raise KeyError(f"unknown tenant {name!r}")
        return self._tenants[name]

    def engine(self, name: str) -> StreamingJoinEngine:
        return self._tenant(name).engine

    def status(self) -> dict[str, TenantStatus]:
        return {nm: t.status() for nm, t in self._tenants.items()}

    def serving(self) -> list[str]:
        return sorted(
            nm
            for nm, t in self._tenants.items()
            if t.state in (RUNNING, DEGRADED)
        )

    # ---- checkpoint (DESIGN.md §9) -----------------------------------------
    _STATE_CODES = {RUNNING: 0, QUARANTINED: 1, DEGRADED: 2, FAILED: 3}

    def save_checkpoint(self, directory: str, keep: int = 3) -> None:
        """Every tenant engine into its own namespace, plus one control
        namespace for the breaker + fair-share state.  Each namespace uses
        the atomic step/LATEST layout, so a kill at ANY point leaves every
        tenant restorable (at worst one batch behind its neighbors)."""
        for nm, t in self._tenants.items():
            t.engine.save_checkpoint(
                tenant_checkpoint_dir(directory, nm), keep=keep
            )
        codes = {nm: self._STATE_CODES[t.state] for nm, t in self._tenants.items()}
        names = sorted(self._tenants)
        tree = {
            "batches": np.array([self.batches], np.int64),
            "breaker": np.array(
                [
                    [
                        codes[nm],
                        self._tenants[nm].failures,
                        self._tenants[nm].reopens,
                        self._tenants[nm].quarantined_until,
                    ]
                    for nm in names
                ],
                np.int64,
            ),
        }
        tree.update(
            {f"fair/{k}": v for k, v in self.fair.state_dict().items()}
        )
        _save(
            tenant_checkpoint_dir(directory, _CONTROL),
            step=self.batches,
            tree=tree,
            keep=keep,
            metadata={"tenants": names},
        )

    @classmethod
    def restore(
        cls,
        directory: str,
        tenants: Iterable[TenantSpec],
        policy: TenancyPolicy = TenancyPolicy(),
        log_fn: Callable[[str], None] | None = None,
        clock: Callable[[], float] | None = None,
        device: str | torch.device = "cuda",
    ) -> "MultiQueryEngine":
        """Rebuild every tenant bit-identically from its namespace, this
        package's checkpoint or the JAX package's, on ``device``."""
        specs = list(tenants)
        # validate the tenant set against the control manifest FIRST, so a
        # spec/checkpoint mismatch fails loudly before any engine loads
        ctrl = tenant_checkpoint_dir(directory, _CONTROL)
        manifest = load_manifest(ctrl)
        saved_names = manifest["metadata"]["tenants"]
        if saved_names != sorted(s.name for s in specs):
            raise ValueError(
                f"checkpoint tenants {saved_names} != restore specs "
                f"{sorted(s.name for s in specs)}"
            )
        out = cls.__new__(cls)
        out.policy = policy
        out.device = _device(device)
        out._log = log_fn or (lambda _msg: None)
        out.obs = Observability(policy.obs)  # fresh shared tracer+registry
        out._tenants = {}
        for spec in specs:
            engine = StreamingJoinEngine.restore(
                tenant_checkpoint_dir(directory, spec.name),
                spec.query,
                spec.config,
                log_fn=log_fn,
                clock=clock,
                device=out.device,
                obs=out.obs.for_tenant(
                    spec.name,
                    arities={r.name: r.arity for r in spec.query.relations},
                ),
            )
            engine.tenant = spec.name
            out._tenants[spec.name] = _Tenant(spec, engine)
        out.fair = FairShareController(
            policy.capacity, {s.name: s.weight for s in specs}
        )
        out._injector = None
        out.shared_sketch_passes = 0
        out._sketch_groups = out._group_sketches()

        _, flat = load_checkpoint(ctrl)
        out.batches = int(np.asarray(flat["batches"])[0])
        code_to_state = {v: k for k, v in cls._STATE_CODES.items()}
        breaker = np.asarray(flat["breaker"])
        for i, nm in enumerate(saved_names):
            t = out._tenants[nm]
            t.state = code_to_state[int(breaker[i, 0])]
            t.failures = int(breaker[i, 1])
            t.reopens = int(breaker[i, 2])
            t.quarantined_until = int(breaker[i, 3])
        out.fair.load_state_dict(
            {
                "shed": flat["fair/shed"],
                "backpressure": flat["fair/backpressure"],
            }
        )
        return out
