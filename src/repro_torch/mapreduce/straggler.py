"""Failure detection for the reduce side (DESIGN.md §5).

Only the host-level detector is here so far; the speculative shard runner
of ``repro.mapreduce.straggler`` (``run_with_speculation``) is not ported
yet.
"""
from __future__ import annotations

from typing import Hashable


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

