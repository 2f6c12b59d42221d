"""Straggler mitigation: speculative re-execution of slow reduce shards (the
port of ``repro.mapreduce.straggler``).

MapReduce-native fault handling (DESIGN.md §5): the reduce phase is split
into independent shards (blocks of reducers).  A shard that runs slower
than ``speculate_after`` x the median completed-shard time gets a backup
execution; the first result wins.  Because shards are deterministic pure
functions, duplicate completion is harmless (results are idempotent).

Failures are first-class (DESIGN.md §5/§8): a shard attempt that raises is
retried up to ``max_attempts`` total submissions; a shard that exhausts
its attempts ends with ``ShardOutcome.error`` set — an explicit report the
caller must handle, never a silent loss.  Exactly ONE ``ShardOutcome`` is
produced per shard, always: a terminal error recorded while a sibling
attempt is still in flight is held pending and materialized once the last
sibling resolves (or when the pool drains), so no ordering of completions,
cancellations, or drops can make a shard vanish from the result list.

Two further seams harden the runner against real-cluster failure modes:

  * ``deadline_s`` — a heartbeat deadline on in-flight attempts: an
    attempt that has neither completed nor failed within the deadline is
    *declared* failed (the zombie worker is fenced: its eventual result
    is ignored once the shard resolves another way) and the attempt
    budget drives a re-submission.  This is the shard-level half of the
    failure detector; ``FailureDetector`` below is the host-level half
    used by the streaming engine (DESIGN.md §5 detection stage).
  * ``checksum_results=True`` — workers seal each result in a CRC32
    envelope *before* it crosses the thread boundary; the collector
    verifies on receipt.  A corrupted result (``repro_torch.testing.faults``
    kind ``corrupt_result``, or a real bit-flip in transit) is detected,
    counted as a failed attempt, and retried — never returned.

A ``repro_torch.testing.faults`` ``FaultInjector`` can wrap each attempt to
exercise exactly these paths deterministically (drop / duplicate / delay /
preempt / corrupt_result).

On a real cluster the backup lands on a different host; here workers are
threads, which is the same control plane with a process-local executor.  A
shard that launches kernels does so from its worker thread, on the
device's current stream; the kernels' build and launch counters are
guarded for that (``kernels._build``).
"""
from __future__ import annotations

import dataclasses
import pickle
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable, Hashable, Sequence


class ChecksumMismatch(RuntimeError):
    """A shard result failed CRC verification on receipt (corrupt in
    transit).  Treated exactly like a failed attempt: retried, and
    terminal after ``max_attempts`` — a corrupt result is never returned."""


@dataclasses.dataclass(frozen=True)
class SealedResult:
    """A shard result sealed by the worker before crossing the thread
    boundary: CRC32 over the pickled payload, verified by the collector."""

    payload: bytes
    crc: int

    @classmethod
    def seal(cls, obj: object) -> "SealedResult":
        payload = pickle.dumps(obj)
        return cls(payload=payload, crc=zlib.crc32(payload))

    def unseal(self) -> object:
        if zlib.crc32(self.payload) != self.crc:
            raise ChecksumMismatch(
                f"shard result CRC mismatch: expected {self.crc:#010x}, "
                f"payload hashes to {zlib.crc32(self.payload):#010x}"
            )
        return pickle.loads(self.payload)


@dataclasses.dataclass
class ShardOutcome:
    shard_id: int
    result: object  # None iff the shard failed terminally
    attempts: int  # total submissions (initial + retries + backups)
    speculated: bool
    elapsed_s: float  # the WINNING attempt's own latency (not first-submit age)
    error: str | None = None  # terminal failure after retries, else None


class FailureDetector:
    """Deadline-based failure detection over member heartbeats.

    The host-level half of DESIGN.md §5 detection: members (hosts, shards)
    record heartbeats at ``now``; ``overdue(now)`` returns every registered
    member whose last heartbeat is ``deadline`` or more behind ``now``.
    Time is whatever monotone clock the caller uses — wall seconds for the
    shard runner, *batch indices* for the streaming engine (which makes
    detection deterministic under test).
    """

    def __init__(self, deadline: float):
        if deadline <= 0:
            raise ValueError("deadline must be > 0")
        self.deadline = float(deadline)
        self._last: dict[Hashable, float] = {}

    def heartbeat(self, member: Hashable, now: float) -> None:
        self._last[member] = float(now)

    def deregister(self, member: Hashable) -> None:
        """Forget a member (declared dead or decommissioned)."""
        self._last.pop(member, None)

    @property
    def members(self) -> tuple[Hashable, ...]:
        return tuple(self._last)

    def overdue(self, now: float) -> list[Hashable]:
        """Members whose heartbeat age >= deadline, oldest-lag first."""
        late = [
            (now - t, m) for m, t in self._last.items()
            if now - t >= self.deadline
        ]
        return [m for _, m in sorted(late, key=lambda p: (-p[0], str(p[1])))]


def run_with_speculation(
    shard_fns: Sequence[Callable[[], object]],
    max_workers: int = 4,
    speculate_after: float = 3.0,
    poll_interval_s: float = 0.01,
    min_completed_before_speculation: int = 2,
    max_attempts: int = 3,
    injector=None,
    deadline_s: float | None = None,
    checksum_results: bool = False,
    metrics=None,
) -> list[ShardOutcome]:
    """Run every shard; re-issue stragglers and failed attempts; return
    exactly one outcome per shard.  ``injector`` (``repro_torch.testing.faults``)
    wraps each attempt for deterministic fault injection; ``max_attempts``
    bounds total submissions per shard, after which the outcome carries
    ``error``.  ``deadline_s`` declares an in-flight attempt failed after
    that many seconds (the zombie is fenced, not killed — threads cannot
    be).  ``checksum_results`` seals results in a worker-side CRC envelope
    verified on receipt; a mismatch counts as a failed attempt.

    ``metrics`` (DESIGN.md §10): anything with ``histogram(name,
    **labels)`` / ``counter(name, **labels)`` — an ``obs.MetricsRegistry``
    or the engine's ``Observability`` facade.  Per-attempt latencies land
    in ``straggler_attempt_seconds`` (label ``outcome=ok|error``) and the
    mitigation events in ``straggler_*_total`` counters.  The instruments
    lock internally, so recording is safe from this runner's collector
    even while worker threads are live."""
    outcomes: dict[int, ShardOutcome] = {}

    def _count(name: str, **labels) -> None:
        if metrics is not None:
            metrics.counter(name, **labels).inc()

    def _observe(seconds: float, **labels) -> None:
        if metrics is not None:
            metrics.histogram("straggler_attempt_seconds", **labels).observe(
                seconds
            )

    def wrapped(i: int, attempt: int) -> Callable[[], object]:
        fn = shard_fns[i]
        if checksum_results:
            inner = fn

            def sealed_fn(inner=inner):
                return SealedResult.seal(inner())

            fn = sealed_fn
        return injector.wrap(i, attempt, fn) if injector is not None else fn

    n = len(shard_fns)
    pending_error: dict[int, str] = {}  # terminal error awaiting last sibling
    submitted: dict[int, int] = {i: 0 for i in range(n)}
    inflight: dict[int, int] = {i: 0 for i in range(n)}
    speculated: set[int] = set()
    declared_dead: set[Future] = set()  # deadline-fenced zombies
    futures: dict[Future, int] = {}
    attempt_start: dict[Future, float] = {}  # per-attempt submit time (S1 fix)

    def record_terminal(i: int, now: float) -> None:
        outcomes[i] = ShardOutcome(
            shard_id=i,
            result=None,
            attempts=submitted[i],
            speculated=i in speculated,
            elapsed_s=0.0,
            error=pending_error.get(i, "no attempt produced an outcome"),
        )

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        def submit(i: int) -> None:
            submitted[i] += 1
            inflight[i] += 1
            f = pool.submit(wrapped(i, submitted[i]))
            futures[f] = i
            attempt_start[f] = time.monotonic()

        for i in range(n):
            copies = 1 + (
                injector.extra_initial_attempts(i) if injector is not None else 0
            )
            for _ in range(copies):
                submit(i)
        durations: list[float] = []

        def attempt_failed(i: int, msg: str, now: float) -> None:
            """One attempt of shard ``i`` is gone (exception, checksum
            mismatch, or deadline): resubmit if budget remains, otherwise
            hold the terminal error and materialize the outcome once no
            sibling is left in flight."""
            if i in outcomes:
                return
            if submitted[i] < max_attempts:
                _count("straggler_retries_total")
                submit(i)
                return
            pending_error.setdefault(i, msg)
            if inflight[i] == 0:
                record_terminal(i, now)
                _count("straggler_shards_failed_total")

        while futures:
            done, _ = wait(
                list(futures), timeout=poll_interval_s, return_when=FIRST_COMPLETED
            )
            now = time.monotonic()
            for f in done:
                i = futures.pop(f)
                started = attempt_start.pop(f)
                inflight[i] -= 1
                if f in declared_dead:
                    declared_dead.discard(f)
                    continue  # fenced: the shard already resolved another way
                if i in outcomes:
                    continue  # backup finished after primary; ignore
                exc = f.exception()
                if exc is not None:
                    _observe(now - started, outcome="error")
                    attempt_failed(i, f"{type(exc).__name__}: {exc}", now)
                    continue
                result = f.result()
                if checksum_results:
                    try:
                        result = result.unseal()
                    except ChecksumMismatch as cm:
                        _observe(now - started, outcome="error")
                        _count("straggler_checksum_mismatches_total")
                        attempt_failed(i, f"ChecksumMismatch: {cm}", now)
                        continue
                elapsed = now - started  # this attempt's own latency
                _observe(elapsed, outcome="ok")
                outcomes[i] = ShardOutcome(
                    shard_id=i,
                    result=result,
                    attempts=submitted[i],
                    speculated=i in speculated,
                    elapsed_s=elapsed,
                )
                durations.append(elapsed)
            # deadline detection: fence in-flight attempts that went silent
            if deadline_s is not None:
                for f, i in list(futures.items()):
                    if f in declared_dead or i in outcomes:
                        continue
                    if now - attempt_start[f] > deadline_s:
                        declared_dead.add(f)
                        inflight[i] -= 1
                        _count("straggler_deadline_fences_total")
                        attempt_failed(
                            i,
                            f"deadline: attempt silent for > {deadline_s:g}s",
                            now,
                        )
            # speculation: compare running shards against median finished time
            if len(durations) >= min_completed_before_speculation:
                med = sorted(durations)[len(durations) // 2]
                for f, i in list(futures.items()):
                    if i in outcomes or i in speculated or f in declared_dead:
                        continue
                    if now - attempt_start[f] > speculate_after * max(med, 1e-4):
                        if submitted[i] >= max_attempts:
                            continue  # attempt budget exhausted
                        speculated.add(i)
                        _count("straggler_speculated_total")
                        submit(i)
            # drop futures whose shard already completed via another attempt
            for f, i in list(futures.items()):
                if i in outcomes and f.done():
                    futures.pop(f)
                    attempt_start.pop(f, None)
                    declared_dead.discard(f)
                    inflight[i] -= 1
    # the pool has drained: every shard must have resolved.  Materialize any
    # terminal error whose last sibling was dropped/cancelled without
    # reaching the loop above — one ShardOutcome per shard, always.
    now = time.monotonic()
    for i in range(n):
        if i not in outcomes:
            record_terminal(i, now)
            _count("straggler_shards_failed_total")
    assert len(outcomes) == n, "straggler runner lost a shard outcome"
    return [outcomes[i] for i in sorted(outcomes)]
