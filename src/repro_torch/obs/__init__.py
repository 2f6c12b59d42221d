"""Observability for the streaming SharesSkew stack (DESIGN.md §10).

Three parts, one facade:

  * :mod:`repro_torch.obs.trace` — nested-span tracer, Chrome/Perfetto export,
    free when disabled;
  * :mod:`repro_torch.obs.metrics` — label-aware counter/gauge/histogram
    registry with dict snapshot + Prometheus text dump;
  * :mod:`repro_torch.obs.skewscope` — exact per-reducer load telemetry (the
    paper's cost objective), imbalance factor, HH hit rate, CMS error.

:class:`Observability` bundles one tracer + one registry + (optionally)
one SkewScope per engine, and injects a ``tenant`` label into every
metric a tenant engine records, so N engines sharing one registry stay
isolated series-wise.  Engines accept the facade as a constructor
argument; :data:`NULL_OBS` (everything disabled) is the default, so
unwired call sites cost a predicate check and nothing else.

:class:`ObsPolicy` is the *user-facing* switch carried on
``StreamConfig``/``TenancyPolicy`` — plain frozen-dataclass bools that
checkpoint round-trip like every other config knob; the engine
constructs the matching facade from it at ``__init__``/``restore``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.obs.metrics import (  # noqa: F401  (re-exports)
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_INSTRUMENT,
)
from repro_torch.obs.skewscope import (  # noqa: F401
    SkewScope,
    SkewSnapshot,
    cms_window_error,
    hh_hit_counts,
)
from repro_torch.obs.trace import NULL_SPAN, Tracer  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ObsPolicy:
    """What to observe.  Everything defaults off — the zero-cost path."""

    trace: bool = False  # nested spans + Chrome/Perfetto export
    metrics: bool = False  # counters/gauges/histograms registry
    skewscope: bool = False  # exact per-reducer load accounting

    @property
    def any(self) -> bool:
        return self.trace or self.metrics or self.skewscope


class Observability:
    """One engine's bundle of tracer + registry + skewscope.

    ``tenant`` (when non-empty) is injected as a label into every
    counter/gauge/histogram lookup, which is the whole per-tenant
    isolation mechanism: same registry, disjoint series.
    """

    def __init__(
        self,
        policy: ObsPolicy = ObsPolicy(),
        tracer: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        tenant: str = "",
        arities: Mapping[str, int] | None = None,
    ):
        self.policy = policy
        self.tracer = tracer if tracer is not None else Tracer(enabled=policy.trace)
        self.metrics = (
            metrics if metrics is not None else MetricsRegistry(enabled=policy.metrics)
        )
        self.tenant = str(tenant)
        self.skew: SkewScope | None = (
            SkewScope(arities) if policy.skewscope and arities is not None else None
        )

    def for_tenant(
        self, tenant: str, arities: Mapping[str, int] | None = None
    ) -> "Observability":
        """A tenant-scoped view: SHARED tracer + registry, own label
        (and own SkewScope — reducer id spaces differ per query)."""
        return Observability(
            policy=self.policy,
            tracer=self.tracer,
            metrics=self.metrics,
            tenant=tenant,
            arities=arities,
        )

    # ---- label-injecting metric helpers ------------------------------------
    def _labels(self, labels: dict) -> dict:
        if self.tenant:
            labels.setdefault("tenant", self.tenant)
        return labels

    def counter(self, name: str, **labels):
        return self.metrics.counter(name, **self._labels(labels))

    def gauge(self, name: str, **labels):
        return self.metrics.gauge(name, **self._labels(labels))

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS, **labels):
        return self.metrics.histogram(name, buckets=buckets, **self._labels(labels))

    # ---- tracing passthrough (so call sites hold one object) ---------------
    def span(self, name: str, cat: str = "stream", args: dict | None = None):
        return self.tracer.span(name, cat, args)

    def instant(self, name: str, cat: str = "stream", args: dict | None = None):
        return self.tracer.instant(name, cat, args)


#: The default wired into engines: everything off, every hook free.
NULL_OBS = Observability()

__all__ = [
    "ObsPolicy",
    "Observability",
    "NULL_OBS",
    "Tracer",
    "NULL_SPAN",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "NULL_INSTRUMENT",
    "DEFAULT_BUCKETS",
    "SkewScope",
    "SkewSnapshot",
    "hh_hit_counts",
    "cms_window_error",
]
