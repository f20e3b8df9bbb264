"""Unified observability: request-lifecycle spans, percentile metrics, and
routing-decision audit — one telemetry vocabulary shared by the DES oracles
(`cluster.simulator`), the physical serving runtime (`serving.scheduler`)
and fleet mode.

Three small modules, all explicit-clock (no wall time is ever read here;
callers pass their own ``now`` — simulated seconds in the DES, scheduler
ticks in serving):

* :mod:`.trace`   — ``Tracer``: per-request span trees with phase
  events (submit, route-decision, queue-wait, prefill, kv-transfer, decode,
  hedge/cancel, retire) in a bounded ring buffer, plus a zero-overhead
  ``NOOP_TRACER``.
* :mod:`.metrics` — ``MetricsRegistry``: vectorized numpy
  histograms (fixed log-spaced bucket edges so per-label counts merge
  exactly), counters and gauges; p50/p95/p99 per (node, category).
* :mod:`.audit`   — ``AuditLog``: one record per router ``route()``
  call (policy, genome, feasible mask, per-candidate estimate rows, chosen
  pair/route, failover reason) so "why did it pick node 7?" is answerable.
* :mod:`.export`  — Chrome-trace/Perfetto JSON for any tracer, and
  a flat metrics dict for benchmarks.

``Obs`` bundles the three so runtime constructors take a single optional
argument; ``Obs.noop()`` (the default everywhere) keeps the hot paths at
method-call cost only.

A copy of ``repro.obs`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .audit import AuditLog, RouteAudit
from .export import chrome_trace, metrics_flat
from .metrics import Histogram, MetricsRegistry
from .trace import NOOP_TRACER, NoopTracer, Phase, Span, SpanEvent, Tracer

__all__ = [
    "AuditLog", "RouteAudit", "Histogram", "MetricsRegistry",
    "NOOP_TRACER", "NoopTracer", "Obs", "Phase", "Span", "SpanEvent",
    "Tracer", "chrome_trace", "metrics_flat",
]


@dataclasses.dataclass
class Obs:
    """The full telemetry bundle threaded through a run.

    ``Obs()`` gives live instances of all three surfaces; ``Obs.noop()``
    swaps the tracer for the shared no-op and leaves metrics/audit unset so
    consumers skip them entirely.
    """

    tracer: Tracer = dataclasses.field(default_factory=Tracer)
    metrics: Optional[MetricsRegistry] = dataclasses.field(
        default_factory=MetricsRegistry)
    audit: Optional[AuditLog] = dataclasses.field(default_factory=AuditLog)

    @classmethod
    def noop(cls) -> "Obs":
        return cls(tracer=NOOP_TRACER, metrics=None, audit=None)

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.metrics is not None \
            or self.audit is not None
