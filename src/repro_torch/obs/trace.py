"""Low-overhead nested-span tracing for the streaming engine (DESIGN.md §10).

One batch through ``StreamingJoinEngine.ingest`` is a tree of phases —
ingest → sketch update → route → delta join → retention/expiry → replan
(solve / migrate / first-kernel compile) → recovery (detect / replay /
repair / verify) — and the only way to see where a batch's time goes is
to clock those phases *as a tree*, not as a flat list of
``perf_counter`` deltas.  ``Tracer`` is that clock:

  * spans are context managers over ``time.perf_counter_ns`` (injectable
    for tests), nested by a plain stack, each stamped with the current
    *batch index* plus a per-batch sequence number — the batch-clocked
    span id, so two runs over the same seeded stream produce the same id
    sequence;
  * ``to_chrome()`` exports the Chrome/Perfetto trace-event JSON format
    (``ph: "X"`` complete events in microseconds), so
    ``tracer.dump("out.json")`` loads directly in ``chrome://tracing`` /
    https://ui.perfetto.dev and renders the nesting by time containment;
  * *disabled is free*: a disabled tracer's ``span()`` returns one
    module-level singleton — no span object, no args dict, no clock
    read, no per-call allocation — so leaving trace hooks in the fused
    hot path costs a predicate check per call and nothing else.  Callers
    that want to attach argument dicts guard their construction with
    ``tracer.enabled`` (the ``args=None`` default keeps the common call
    allocation-free).

The tracer is deliberately single-threaded (the engine's batch loop);
thread-fanout code (``mapreduce.straggler``) records per-attempt
latencies into ``obs.metrics`` histograms instead, which lock.
"""
from __future__ import annotations

import json
import time
from typing import Callable


class _NullSpan:
    """The disabled-tracer span: one shared instance, no state, no cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One open span; closing it appends a finished event to the tracer."""

    __slots__ = ("_tracer", "name", "cat", "args", "span_id", "_start_ns")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.span_id = ""
        self._start_ns = 0

    def __enter__(self) -> "_Span":
        t = self._tracer
        t._seq += 1
        self.span_id = f"{t._batch}.{t._seq}"
        t._stack.append(self)
        self._start_ns = t._clock_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t = self._tracer
        end_ns = t._clock_ns()
        if t._stack and t._stack[-1] is self:
            t._stack.pop()
        args = dict(self.args) if self.args else {}
        args["batch"] = t._batch
        args["span_id"] = self.span_id
        t.events.append(
            {
                "name": self.name,
                "cat": self.cat,
                "ph": "X",
                "ts": (self._start_ns - t._epoch_ns) / 1e3,  # µs
                "dur": (end_ns - self._start_ns) / 1e3,
                "pid": t.pid,
                "tid": t.tid,
                "args": args,
            }
        )
        return False


class Tracer:
    """Nested-span tracer with Chrome/Perfetto trace-event export.

    ``enabled=False`` (the default) makes every hook free: ``span()``
    returns ``NULL_SPAN`` and ``instant()`` returns immediately.
    """

    def __init__(
        self,
        enabled: bool = False,
        clock_ns: Callable[[], int] | None = None,
        pid: int = 0,
        tid: int = 0,
    ):
        self.enabled = bool(enabled)
        self._clock_ns = clock_ns or time.perf_counter_ns
        self.pid = int(pid)
        self.tid = int(tid)
        self._epoch_ns = self._clock_ns()
        self._batch = -1  # set_batch() before the first ingest
        self._seq = 0
        self._stack: list[_Span] = []
        self.events: list[dict] = []

    # ---- recording ---------------------------------------------------------
    def set_batch(self, batch: int) -> None:
        """Advance the batch clock: span ids restart at ``<batch>.1``."""
        if not self.enabled:
            return
        self._batch = int(batch)
        self._seq = 0

    def span(self, name: str, cat: str = "stream", args: dict | None = None):
        """Context manager clocking one phase.  ``args`` (optional dict)
        lands in the trace event; pass it pre-built and guard expensive
        construction with ``tracer.enabled``."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "stream", args: dict | None = None) -> None:
        """A zero-duration marker (``ph: "i"``) — decisions, triggers."""
        if not self.enabled:
            return
        self._seq += 1
        a = dict(args) if args else {}
        a["batch"] = self._batch
        a["span_id"] = f"{self._batch}.{self._seq}"
        self.events.append(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": (self._clock_ns() - self._epoch_ns) / 1e3,
                "pid": self.pid,
                "tid": self.tid,
                "args": a,
            }
        )

    @property
    def depth(self) -> int:
        """Current open-span nesting depth (0 outside any span)."""
        return len(self._stack)

    def clear(self) -> None:
        self.events = []
        self._stack = []
        self._seq = 0

    # ---- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        """Write ``to_chrome()`` to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path

    def span_names(self) -> list[str]:
        """Distinct event names in first-seen order (test/report helper)."""
        seen: dict[str, None] = {}
        for ev in self.events:
            seen.setdefault(ev["name"], None)
        return list(seen)
