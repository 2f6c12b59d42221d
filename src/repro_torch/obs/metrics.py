"""Process-local metrics registry: counters, gauges, histograms
(DESIGN.md §10).

The streaming stack already *computes* its telemetry — shed/deferred
rows, breaker transitions, fair-share trims, replan triggers, checkpoint
sizes — but each number lives on whichever object produced it.  The
registry gives them one label-aware home with two export surfaces:

  * ``snapshot()`` — a plain nested dict with deterministically sorted
    keys.  Counters and gauges driven by seeded streams are bit-stable
    run over run (the determinism contract ``pytest -m obs`` asserts);
    wall-time lives ONLY in histograms, whose bucket *counts* are stable
    but whose ``sum`` is not — consumers that diff snapshots compare
    ``counters``/``gauges``.
  * ``to_prometheus()`` — the Prometheus text exposition format, so a
    scrape endpoint is one ``web.Response(registry.to_prometheus())``
    away.

Labels are plain kwargs (``registry.counter("stream_shed_rows_total",
tenant="q1", rel="R")``); the instrument key is ``(name, sorted label
items)``, so the same call site with a different tenant label yields an
isolated instrument — the per-tenant isolation the tenancy tests assert.
A disabled registry (``MetricsRegistry(enabled=False)``) hands every
caller shared null instruments whose ``inc``/``set``/``observe`` are
no-ops, keeping the wired-but-off cost to a dict miss per lookup.

Instruments lock on mutation: ``mapreduce.straggler`` observes attempt
latencies from its worker pool, so histograms must tolerate threads.
"""
from __future__ import annotations

import threading

# default latency buckets (seconds): 100µs .. ~100s, exponential
DEFAULT_BUCKETS = tuple(1e-4 * (4.0**i) for i in range(11))

_LabelKey = tuple[tuple[str, str], ...]


def _labelkey(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey, extra: tuple[tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        with self._lock:
            self.value += amount


class Gauge:
    """A value that can go anywhere."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Fixed-bucket histogram (cumulative on export, Prometheus-style)."""

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        if list(buckets) != sorted(buckets) or not buckets:
            raise ValueError("histogram buckets must be sorted and non-empty")
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1
            self.sum += v
            self.count += 1

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class _NullInstrument:
    """Shared no-op stand-in handed out by a disabled registry."""

    __slots__ = ()
    value = 0.0
    sum = 0.0
    count = 0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Label-aware get-or-create registry with dict + Prometheus export."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._counters: dict[tuple[str, _LabelKey], Counter] = {}
        self._gauges: dict[tuple[str, _LabelKey], Gauge] = {}
        self._histograms: dict[tuple[str, _LabelKey], Histogram] = {}
        self._lock = threading.Lock()

    # ---- get-or-create -----------------------------------------------------
    def counter(self, name: str, **labels) -> Counter | _NullInstrument:
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _labelkey(labels))
        inst = self._counters.get(key)
        if inst is None:
            with self._lock:
                inst = self._counters.setdefault(key, Counter())
        return inst

    def gauge(self, name: str, **labels) -> Gauge | _NullInstrument:
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _labelkey(labels))
        inst = self._gauges.get(key)
        if inst is None:
            with self._lock:
                inst = self._gauges.setdefault(key, Gauge())
        return inst

    def histogram(
        self,
        name: str,
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        **labels,
    ) -> Histogram | _NullInstrument:
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _labelkey(labels))
        inst = self._histograms.get(key)
        if inst is None:
            with self._lock:
                inst = self._histograms.setdefault(key, Histogram(buckets))
        return inst

    # ---- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic nested dict: series keyed ``name{labels}``.
        Counters/gauges are reproducible under seeded streams; histogram
        ``sum`` carries wall time and is excluded from determinism
        contracts (compare ``counters``/``gauges``)."""
        counters = {
            name + _fmt_labels(lk): c.value
            for (name, lk), c in sorted(self._counters.items())
        }
        gauges = {
            name + _fmt_labels(lk): g.value
            for (name, lk), g in sorted(self._gauges.items())
        }
        histograms = {
            name + _fmt_labels(lk): {
                "count": h.count,
                "sum": h.sum,
                "buckets": {
                    ("+Inf" if i == len(h.buckets) else repr(h.buckets[i])): c
                    for i, c in enumerate(h.cumulative())
                },
            }
            for (name, lk), h in sorted(self._histograms.items())
        }
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one TYPE line per family)."""
        lines: list[str] = []
        seen_type: set[str] = set()

        def type_line(name: str, kind: str) -> None:
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, lk), c in sorted(self._counters.items()):
            type_line(name, "counter")
            lines.append(f"{name}{_fmt_labels(lk)} {_fmt_value(c.value)}")
        for (name, lk), g in sorted(self._gauges.items()):
            type_line(name, "gauge")
            lines.append(f"{name}{_fmt_labels(lk)} {_fmt_value(g.value)}")
        for (name, lk), h in sorted(self._histograms.items()):
            type_line(name, "histogram")
            cum = h.cumulative()
            for i, b in enumerate(h.buckets):
                le = _fmt_labels(lk, (("le", repr(b)),))
                lines.append(f"{name}_bucket{le} {cum[i]}")
            inf = _fmt_labels(lk, (("le", "+Inf"),))
            lines.append(f"{name}_bucket{inf} {cum[-1]}")
            lines.append(f"{name}_sum{_fmt_labels(lk)} {_fmt_value(h.sum)}")
            lines.append(f"{name}_count{_fmt_labels(lk)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(v)
