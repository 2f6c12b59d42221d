"""Deterministic fault injection for the execution seams (DESIGN.md §8):
a copy of ``repro.testing.faults`` (numpy and the standard library only).

In the port the host and sketch seams serve the streaming engine
(``stream.engine.StreamingJoinEngine.arm_faults`` and ``FaultySketchTap``),
the shard seam the speculative reduce (``mapreduce.straggler.
run_with_speculation`` under ``mapreduce.run_join_speculative``), and the
tenant seam the multi-tenant engine (``stream.tenancy.MultiQueryEngine``).
The module is kept whole so a fault schedule means the same to both
packages.

The robustness claims of the speculative executor and the streaming engine
are only claims until something actually fails.  This harness injects
failures *deterministically* — by (shard, attempt) or by ingest batch, not
by random chance — at the two seams where a real deployment loses work:

  * **Reduce shards** (``mapreduce.straggler.run_with_speculation``): a
    ``FaultInjector`` wraps each shard attempt.  ``drop`` kills the attempt
    before any work, ``preempt`` kills it after the work but before the
    result is reported (compute lost), ``delay`` stalls it into straggler
    territory, and ``duplicate`` races a second copy of the attempt from
    the start.  The executor must end every faulted shard in one of two
    states — a successful retry/backup, or an explicit per-shard error that
    propagates to the caller — never a silently absorbed loss.  Shard
    results combine associatively (counts/checksums add mod 2^32), so
    duplicate completions are idempotent by construction and the harness
    verifies the final (count, checksum) is fault-invariant.
  * **Sketch increments** (``FaultySketchTap`` around ``StreamHHTracker``):
    dropped or duplicated Count-Min/SpaceSaving updates degrade *planning
    quality only* — the join fingerprint must be bit-identical, because
    correctness never depends on the sketch.  The tap records every
    tampered batch so a test can assert both halves of that contract.
  * **Hosts** (``target="host"``, consumed by the streaming engine's
    recovery subsystem, DESIGN.md §5): ``host_loss`` permanently kills a
    host at an *absolute* batch index — its reducers' carried state is
    gone and must be lineage-replayed onto survivors; ``partition``
    silences a host's heartbeats for ``heal_after`` batches without
    destroying state — the detector (correctly) declares it lost, and on
    healing the stale host is fenced and rejoins as an empty spare.
    Batch indices are absolute (``len(engine.reports)``), so a schedule
    survives checkpoint/restore without re-firing pre-kill faults.
  * **Result integrity** (``corrupt_result``): flips bytes in a shard's
    sealed result envelope after the compute but before the collector
    reads it.  Requires ``checksum_results=True`` on the runner — the CRC
    check turns silent corruption into a failed attempt (retried, or an
    explicit error), never a wrong answer.

Every injected fault is recorded as a ``FaultEvent``; ``resolve()`` maps
events to shard outcomes and ``assert_all_resolved()`` fails a test if any
fault vanished without a retry-success or an explicit report.  Host events
are resolved by the engine when recovery completes (``outcome="result"``)
or exhausts (``outcome="error"`` — still explicit, still resolved).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np

KINDS = (
    "drop",
    "duplicate",
    "delay",
    "preempt",
    "host_loss",
    "partition",
    "corrupt_result",
    "poison_rows",
    "tenant_overload",
)
TARGETS = ("shard", "sketch", "host", "tenant")

POISON_MODES = ("domain", "nan", "arity", "missing")


def _poison_rows(rows, mode: str):
    """One relation's rows tampered into a schema violation the engine's
    ``_validate_batch`` must reject (``missing`` is handled by the caller,
    which drops the relation from the view entirely)."""
    rows = np.asarray(rows)
    if mode == "domain":
        if rows.shape[0] == 0:
            return np.full((1, max(1, rows.shape[-1] if rows.ndim == 2 else 1)),
                           2**40, dtype=np.int64)
        out = rows.astype(np.int64, copy=True).reshape(rows.shape)
        out.flat[0] = 2**40  # outside the int32 routing domain
        return out
    if mode == "nan":
        out = rows.astype(np.float64, copy=True)
        if out.shape[0] == 0:
            out = np.full((1, max(1, out.shape[-1] if out.ndim == 2 else 1)),
                          np.nan)
        else:
            out.flat[0] = np.nan
        return out
    if mode == "arity":
        wide = rows.reshape(rows.shape[0], -1) if rows.ndim == 2 else rows
        if wide.ndim != 2 or wide.shape[0] == 0:
            wide = np.zeros((1, 1), dtype=np.int64)
        return np.concatenate(
            [wide, np.zeros((wide.shape[0], 1), dtype=wide.dtype)], axis=1
        )
    return rows  # "missing": caller deletes the key


class InjectedFault(RuntimeError):
    """An injected shard failure (worker died before doing the work)."""


class InjectedPreemption(InjectedFault):
    """An injected preemption: the attempt finished its compute but the
    worker died before reporting — the result is lost, not the input."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault.

    ``target="shard"``: fires on shard ``shard_id``'s attempt number
    ``attempt`` (1-based; speculative/duplicate submissions count).
    ``target="sketch"``: fires on the ``batch``-th tapped observe call.
    ``target="host"``: fires at the *absolute* batch index ``batch``
    (``len(engine.reports)`` at the boundary), killing (``host_loss``) or
    partitioning (``partition``, healing after ``heal_after`` batches)
    host ``host_id``.  In multi-tenant runs ``tenant`` scopes the fault to
    one query's recovery domain ("" = every tenant, the single-tenant
    default).
    ``target="tenant"``: tampers tenant ``tenant``'s *view* of the shared
    batch at absolute index ``batch`` — ``poison_rows`` injects a
    schema-violating batch (mode ``poison``: out-of-``domain`` value, NaN,
    wrong ``arity``, ``missing`` relation) that the victim's validation
    must reject and its circuit breaker must contain; ``tenant_overload``
    inflates relation ``rel`` by ``rows`` duplicate rows so fair-share
    shedding trims the offender, not its neighbors.
    """

    kind: str  # drop | duplicate | delay | preempt | host_loss | partition
    #            | corrupt_result | poison_rows | tenant_overload
    target: str = "shard"
    shard_id: int = 0
    attempt: int = 1
    batch: int = 0  # sketch faults: which observe() call to tamper;
    #                 host/tenant faults: absolute batch index to fire at
    delay_s: float = 0.05  # delay faults: how long to stall
    host_id: int = 0  # host faults: which host dies / is partitioned
    heal_after: int = 2  # partition faults: batches until the host rejoins
    tenant: str = ""  # host/tenant faults: which query is targeted
    rel: str = ""  # tenant faults: which relation to tamper ("" = first)
    poison: str = "domain"  # poison_rows mode (POISON_MODES)
    rows: int = 1024  # tenant_overload: duplicate rows injected

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.target not in TARGETS:
            raise ValueError(f"unknown fault target {self.target!r}")
        if self.target == "sketch" and self.kind not in ("drop", "duplicate"):
            raise ValueError("sketch faults support drop/duplicate only")
        if self.kind in ("host_loss", "partition") and self.target != "host":
            raise ValueError(f"{self.kind} faults require target='host'")
        if self.target == "host" and self.kind not in ("host_loss", "partition"):
            raise ValueError("host faults support host_loss/partition only")
        if self.kind == "corrupt_result" and self.target != "shard":
            raise ValueError("corrupt_result faults require target='shard'")
        if self.kind == "partition" and self.heal_after < 1:
            raise ValueError("partition heal_after must be >= 1 batch")
        if self.kind in ("poison_rows", "tenant_overload"):
            if self.target != "tenant":
                raise ValueError(f"{self.kind} faults require target='tenant'")
            if not self.tenant:
                raise ValueError(f"{self.kind} faults need a tenant name")
        if self.target == "tenant":
            if self.kind not in ("poison_rows", "tenant_overload"):
                raise ValueError(
                    "tenant faults support poison_rows/tenant_overload only"
                )
            if self.poison not in POISON_MODES:
                raise ValueError(f"unknown poison mode {self.poison!r}")
            if self.kind == "tenant_overload" and self.rows < 1:
                raise ValueError("tenant_overload rows must be >= 1")


@dataclasses.dataclass
class FaultEvent:
    """One fault actually fired, and how it ended."""

    spec: FaultSpec
    action: str  # raised | delayed | duplicated | dropped_increment |
    #              duplicated_increment | host_lost | partitioned |
    #              poisoned | overloaded
    resolved: bool = False  # retry succeeded, or failure explicitly reported
    outcome: str = ""  # "result" | "error" once resolved ("" before/never)
    tenant: str = ""  # which recovery domain the event fired in (host
    #                   faults: an unscoped spec fires once per tenant)


@dataclasses.dataclass(frozen=True)
class FaultReport:
    """Summary of one injection run (see ``FaultInjector.report``)."""

    injected: int  # events fired
    retried_ok: int  # shard faults whose shard still produced a result
    reported: int  # shard faults whose shard ended in an explicit error
    sketch_tampered: int  # sketch increments dropped/duplicated (quality-only)
    unresolved: int  # faults with neither outcome — must be 0
    recovered: int = 0  # host faults the engine recovered from (lineage
    #                     replay or degraded repair; exhaustion counts as
    #                     ``reported``)
    contained: int = 0  # tenant faults whose blast radius stayed inside the
    #                     victim query (quarantine / counted shedding)


class FaultInjector:
    """Deterministic fault schedule + thread-safe event log.

    Pass to ``run_with_speculation`` / ``run_join_speculative`` (shard
    faults) and/or wrap an engine's tracker in ``FaultySketchTap`` (sketch
    faults).  After the run, ``resolve(outcomes)`` classifies every event
    and ``assert_all_resolved()`` enforces the never-silent contract.
    """

    def __init__(self, faults: Iterable[FaultSpec]):
        self.faults = tuple(faults)
        self.events: list[FaultEvent] = []
        self._lock = threading.Lock()

    def _record(
        self, spec: FaultSpec, action: str, tenant: str = ""
    ) -> FaultEvent:
        ev = FaultEvent(spec=spec, action=action, tenant=tenant)
        with self._lock:
            self.events.append(ev)
        return ev

    # ---- shard seam --------------------------------------------------------
    def extra_initial_attempts(self, shard_id: int) -> int:
        """How many duplicate copies of shard ``shard_id`` to race from the
        start (the ``duplicate`` fault: a retried RPC that was not lost)."""
        n = 0
        for s in self.faults:
            if (
                s.target == "shard"
                and s.kind == "duplicate"
                and s.shard_id == shard_id
            ):
                self._record(s, "duplicated")
                n += 1
        return n

    def wrap(
        self, shard_id: int, attempt: int, fn: Callable[[], object]
    ) -> Callable[[], object]:
        """Apply the faults scheduled for (shard, attempt) around ``fn``."""
        specs = [
            s
            for s in self.faults
            if s.target == "shard"
            and s.shard_id == shard_id
            and s.attempt == attempt
            and s.kind in ("drop", "delay", "preempt", "corrupt_result")
        ]
        if not specs:
            return fn

        def faulted():
            for s in specs:
                if s.kind == "delay":
                    self._record(s, "delayed")
                    time.sleep(s.delay_s)
            for s in specs:
                if s.kind == "drop":
                    self._record(s, "raised")
                    raise InjectedFault(
                        f"shard {shard_id} attempt {attempt}: injected drop"
                    )
            result = fn()
            for s in specs:
                if s.kind == "preempt":
                    self._record(s, "raised")
                    raise InjectedPreemption(
                        f"shard {shard_id} attempt {attempt}: preempted "
                        "after compute, result lost"
                    )
            for s in specs:
                if s.kind == "corrupt_result":
                    result = self._corrupt(s, shard_id, attempt, result)
            return result

        return faulted

    def _corrupt(self, spec: FaultSpec, shard_id: int, attempt: int, result):
        """Flip a byte in a sealed result's payload without updating the
        CRC — in-transit corruption the collector's checksum must catch."""
        payload = getattr(result, "payload", None)
        crc = getattr(result, "crc", None)
        if not isinstance(payload, bytes) or crc is None:
            raise RuntimeError(
                f"corrupt_result on shard {shard_id} attempt {attempt} needs "
                "a sealed result envelope — run with checksum_results=True"
            )
        self._record(spec, "corrupted")
        tampered = bytes([payload[0] ^ 0xFF]) + payload[1:]
        return dataclasses.replace(result, payload=tampered)

    # ---- sketch seam -------------------------------------------------------
    def sketch_faults(self, call_index: int) -> list[FaultSpec]:
        return [
            s
            for s in self.faults
            if s.target == "sketch" and s.batch == call_index
        ]

    # ---- host seam ---------------------------------------------------------
    def fire_host_faults(self, batch: int, tenant: str = "") -> list[FaultEvent]:
        """Record and return the host faults scheduled for the *absolute*
        batch index ``batch`` — each fires exactly once even across a
        checkpoint/restore boundary, because a restored engine resumes at
        ``len(reports)`` past every already-fired index.  The engine marks
        the returned events resolved once recovery completes (or fails
        explicitly).

        ``tenant`` is the recovery domain doing the asking: a spec scoped
        to one tenant fires only in that tenant's engine, while an
        unscoped spec (``tenant=""``) fires everywhere — so a targeted
        host loss repairs one query and leaves its neighbors' reducer
        state untouched (the isolation contract of DESIGN.md §9)."""
        events = []
        with self._lock:
            fired = {
                (id(ev.spec), ev.tenant)
                for ev in self.events
                if ev.spec.target == "host"
            }
        for s in self.faults:
            if s.target != "host" or s.batch != batch:
                continue
            if s.tenant not in ("", tenant) or (id(s), tenant) in fired:
                continue
            action = "host_lost" if s.kind == "host_loss" else "partitioned"
            events.append(self._record(s, action, tenant=tenant))
        return events

    @staticmethod
    def mark_host_event(ev: FaultEvent, recovered: bool) -> None:
        """Resolve a host event: ``recovered=True`` means lineage replay or
        degraded repair restored exactness; ``False`` means recovery was
        exhausted and the engine raised — explicit either way."""
        ev.resolved = True
        ev.outcome = "result" if recovered else "error"

    # ---- tenant seam (DESIGN.md §9) ----------------------------------------
    def apply_tenant_faults(
        self, batch: int, tenant: str, view: dict
    ) -> tuple[dict, list[FaultEvent]]:
        """Return tenant ``tenant``'s (possibly tampered) view of the
        shared batch at absolute index ``batch``, plus the events fired.

        The tampering happens *per tenant view* — the shared batch object
        is never mutated, so neighbors read pristine rows (the whole point
        of tenant-targeted injection: only the victim's ingest sees the
        poison).  The ``MultiQueryEngine`` resolves the returned events via
        ``mark_tenant_event`` once it has contained the damage (quarantine
        for poison, counted shedding for overload); an unresolved tenant
        event fails ``assert_all_resolved``.
        """
        specs = [
            s
            for s in self.faults
            if s.target == "tenant" and s.batch == batch and s.tenant == tenant
        ]
        if not specs:
            return view, []
        out = {nm: np.asarray(rows) for nm, rows in view.items()}
        events = []
        for s in specs:
            nm = s.rel or sorted(out)[0]
            if nm not in out:
                raise ValueError(
                    f"tenant fault targets relation {nm!r}, not in batch"
                )
            if s.kind == "poison_rows":
                events.append(self._record(s, "poisoned", tenant=tenant))
                out[nm] = _poison_rows(out[nm], s.poison)
                if s.poison == "missing":
                    del out[nm]
            else:
                events.append(self._record(s, "overloaded", tenant=tenant))
                rows = out[nm]
                if rows.shape[0]:
                    reps = -(-s.rows // rows.shape[0])  # ceil
                    extra = np.tile(rows, (reps, 1))[: s.rows]
                    out[nm] = np.concatenate([rows, extra], axis=0)
        return out, events

    @staticmethod
    def mark_tenant_event(ev: FaultEvent, contained: bool) -> None:
        """Resolve a tenant event: ``contained=True`` means the engine
        quarantined the victim / shed the overload with exact counters and
        every neighbor stayed bit-identical; ``False`` means containment
        itself failed (the run should fail its test)."""
        ev.resolved = True
        ev.outcome = "result" if contained else "error"

    # ---- resolution --------------------------------------------------------
    def resolve(self, outcomes: Sequence) -> None:
        """Mark each shard event resolved by its shard's final
        ``ShardOutcome``: a result (retry/backup won) or an explicit
        ``error`` both count; a missing outcome does not.  Sketch events
        are quality-only and resolve by having been recorded."""
        by_id = {o.shard_id: o for o in outcomes}
        with self._lock:
            for ev in self.events:
                if ev.spec.target == "sketch":
                    ev.resolved = True
                    continue
                if ev.spec.target == "host":
                    continue  # resolved by the engine via mark_host_event
                o = by_id.get(ev.spec.shard_id)
                if o is None:
                    ev.resolved, ev.outcome = False, ""
                elif o.result is not None:
                    ev.resolved, ev.outcome = True, "result"
                elif o.error is not None:
                    ev.resolved, ev.outcome = True, "error"
                else:
                    ev.resolved, ev.outcome = False, ""

    def report(self) -> FaultReport:
        with self._lock:
            events = list(self.events)
        retried_ok = reported = sketch = unresolved = recovered = 0
        contained = 0
        for ev in events:
            if ev.spec.target == "sketch":
                sketch += 1
            elif ev.spec.target == "tenant" and ev.outcome == "result":
                contained += 1
            elif ev.spec.target == "host" and ev.outcome == "result":
                recovered += 1
            elif ev.outcome == "result":
                retried_ok += 1
            elif ev.outcome == "error":
                reported += 1
            else:
                unresolved += 1
        return FaultReport(
            injected=len(events),
            retried_ok=retried_ok,
            reported=reported,
            sketch_tampered=sketch,
            unresolved=unresolved,
            recovered=recovered,
            contained=contained,
        )

    def assert_all_resolved(self) -> None:
        """Fail loudly if any injected fault was neither survived by a
        retry/backup nor surfaced as an explicit shard error."""
        with self._lock:
            bad = [ev for ev in self.events if not ev.resolved]
        if bad:
            raise AssertionError(
                f"{len(bad)} injected fault(s) silently absorbed: "
                + "; ".join(
                    f"{ev.spec.kind}@host{ev.spec.host_id}/batch{ev.spec.batch}"
                    if ev.spec.target == "host"
                    else f"{ev.spec.kind}@tenant{ev.spec.tenant!r}"
                    f"/batch{ev.spec.batch}"
                    if ev.spec.target == "tenant"
                    else f"{ev.spec.kind}@shard{ev.spec.shard_id}"
                    f"/attempt{ev.spec.attempt}"
                    for ev in bad
                )
            )


class FaultySketchTap:
    """Transparent proxy over ``StreamHHTracker`` that drops or duplicates
    whole-batch sketch increments per the injector's schedule.  Everything
    else (snapshots, rates, checkpoint state) passes through untouched, so
    an engine keeps working — with a degraded skew picture.  Tampering is
    quality-only by design: the engine's join fingerprint must not move.

    ``first_call`` anchors the tap's call counter: a tap on a restored
    engine must pass ``len(engine.reports)`` so batch-indexed faults that
    fired before the kill do not re-fire after the restore (the counter
    resumes where the pre-kill engine's left off).

    """

    def __init__(self, tracker, injector: FaultInjector, first_call: int = 0):
        self._tracker = tracker
        self._injector = injector
        self._calls = first_call

    def __getattr__(self, name):
        return getattr(self._tracker, name)

    def _apply(self, do_observe: Callable[[], None]) -> None:
        idx = self._calls
        self._calls += 1
        specs = self._injector.sketch_faults(idx)
        if any(s.kind == "drop" for s in specs):
            for s in specs:
                if s.kind == "drop":
                    self._injector._record(s, "dropped_increment")
            return  # the whole batch's increments are lost
        do_observe()
        for s in specs:
            if s.kind == "duplicate":
                self._injector._record(s, "duplicated_increment")
                do_observe()  # double-counted increments

    def observe(self, batch) -> None:
        self._apply(lambda: self._tracker.observe(batch))

    def observe_absorbed(self, batch, deltas) -> None:
        self._apply(lambda: self._tracker.observe_absorbed(batch, deltas))
