"""Vectorized metrics: histograms, counters, gauges on numpy.

Design constraints (and why):

* **Fixed log-spaced bucket edges** shared by every histogram. Percentiles
  come from bucket counts, so two histograms of the same metric (e.g. the
  per-node TTFT hists) merge *exactly* by summing their count vectors —
  ``MetricsRegistry.percentiles(name)`` aggregates across labels without
  re-touching raw samples.
* **Vectorized observe**: DES runs ingest whole result arrays in a handful
  of ``np.searchsorted`` + ``np.add.at`` calls; the serving runtime
  observes scalars per retirement. Both land in the same buckets.
* **Label model**: every series is keyed ``(name, node, category)`` with
  ``-1`` meaning "unlabelled/all". The registry auto-maintains the global
  ``(-1, -1)`` series on labelled observes so unqualified percentile
  queries never need a merge.

Canonical metric names (unit = the emitter's clock/currency, documented in
docs/architecture.md): ``ttft``, ``tpot``, ``queue_wait``, ``transfer``,
``cache_hit_frac``, ``spend``, ``latency``.

A copy of ``repro.obs.metrics`` (numpy; the port imports nothing of
``repro``).
"""
from __future__ import annotations

import math
from bisect import bisect_right
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BUCKET_LO", "BUCKET_HI", "N_BUCKETS", "Histogram",
           "CounterVec", "Gauge", "MetricsRegistry", "METRIC_NAMES"]

#: Metric vocabulary every emitter draws from (free-form names still work,
#: these are the ones the docs/tests pin down).
METRIC_NAMES = ("ttft", "tpot", "queue_wait", "transfer", "cache_hit_frac",
                "spend", "latency")

# Shared bucket layout: 120 log-spaced buckets spanning 1e-6 .. 1e6 plus an
# underflow bucket for values <= lo (zeros included). ~26% resolution per
# bucket; percentile error is bounded by one bucket width and further
# clamped to the observed [min, max].
BUCKET_LO = 1e-6
BUCKET_HI = 1e6
N_BUCKETS = 120

_EDGES = np.logspace(math.log10(BUCKET_LO), math.log10(BUCKET_HI),
                     N_BUCKETS - 1)
# geometric bucket representatives: underflow -> lo, bucket k -> geo-mean
# of its bounds, overflow -> hi
_REPR = np.concatenate([
    [BUCKET_LO],
    np.sqrt(_EDGES[:-1] * _EDGES[1:]),
    [BUCKET_HI],
])
# bisect on a plain list beats np.searchsorted ~10x for single samples —
# the serving retire path observes scalars, and its budget is 5% of fleet
# throughput (benchmarks/obs_overhead.py)
_EDGES_LIST = _EDGES.tolist()


class Histogram:
    """Fixed-edge log histogram with exact count, sum, min and max.

    ``observe`` accepts scalars or arrays. ``percentile(q)`` returns the
    geometric midpoint of the bucket holding the q-th sample, clamped to
    the observed range — so degenerate distributions (all zeros, single
    value) report exactly.
    """

    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    def __init__(self):
        self.counts = np.zeros(N_BUCKETS, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, values) -> None:
        if isinstance(values, (int, float)):
            return self.observe_one(values)
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(_EDGES, v, side="right")
        np.add.at(self.counts, idx, 1)
        self.n += v.size
        self.total += float(v.sum())
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))

    def observe_one(self, value: float) -> None:
        """Scalar fast path (identical buckets to :meth:`observe`)."""
        v = float(value)
        self.counts[bisect_right(_EDGES_LIST, v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "Histogram") -> None:
        """Exact merge (same fixed edges everywhere)."""
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else math.nan

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nan when empty."""
        if self.n == 0:
            return math.nan
        rank = q / 100.0 * (self.n - 1)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank + 1))
        est = float(_REPR[min(b, N_BUCKETS - 1)])
        return min(max(est, self.vmin), self.vmax)

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> dict:
        return {f"p{g:g}": self.percentile(g) for g in qs}


class CounterVec:
    """A named vector of monotonic counters (one slot per node, say).

    ``add`` is vectorized: ``add(nodes, values)`` scatters with
    ``np.add.at`` so fleet phase-B commits update per-node token counters
    in one call from the already-host-side stacked arrays.
    """

    __slots__ = ("values",)

    def __init__(self, size: int = 1, dtype=np.int64):
        self.values = np.zeros(size, dtype)

    def add(self, idx=None, amount=1) -> None:
        if idx is None:
            self.values[0] += amount
        elif isinstance(idx, (int, np.integer)):
            self.values[idx] += amount
        else:
            np.add.at(self.values, np.asarray(idx), amount)

    @property
    def total(self):
        return self.values.sum()

    def __getitem__(self, i):
        return self.values[i]


class Gauge:
    """Last-write-wins scalar (or vector) measurement."""

    __slots__ = ("values",)

    def __init__(self, size: int = 1):
        self.values = np.zeros(size, np.float64)

    def set(self, value, idx=None) -> None:
        if idx is None:
            self.values[...] = value
        else:
            self.values[np.asarray(idx)] = value

    def __getitem__(self, i):
        return self.values[i]


LabelKey = Tuple[str, int, int]


class MetricsRegistry:
    """One queryable surface for every series a run produces.

    Histograms are keyed ``(name, node, category)``; counters and gauges by
    name alone (they carry their own vector index). Labelled observes also
    feed the global ``(name, -1, -1)`` series, so ``percentiles("ttft")``
    needs no merge and ``percentiles("ttft", node=3)`` is one lookup.
    """

    def __init__(self):
        self._hists: Dict[LabelKey, Histogram] = {}
        self._counters: Dict[str, CounterVec] = {}
        self._gauges: Dict[str, Gauge] = {}

    # -- histograms ----------------------------------------------------------
    def hist(self, name: str, node: int = -1, category: int = -1
             ) -> Histogram:
        key = (name, node, category)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        return h

    def observe(self, name: str, values, node: int = -1,
                category: int = -1) -> None:
        self.hist(name, node, category).observe(values)
        if node != -1 or category != -1:
            self.hist(name).observe(values)

    def observe_by(self, name: str, values, nodes,
                   categories=None) -> None:
        """Vectorized labelled ingest: group ``values`` by (node, category)
        and observe each group once. One Python iteration per distinct
        label pair, numpy everywhere else."""
        v = np.asarray(values, np.float64).ravel()
        nd = np.broadcast_to(np.asarray(nodes), v.shape)
        ct = (np.broadcast_to(np.asarray(categories), v.shape)
              if categories is not None else np.full(v.shape, -1))
        self.hist(name).observe(v)
        pairs = np.stack([nd, ct], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        for k, (node, cat) in enumerate(uniq):
            self.hist(name, int(node), int(cat)).observe(v[inv == k])

    # -- counters / gauges ---------------------------------------------------
    def counter(self, name: str, size: int = 1) -> CounterVec:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = CounterVec(size)
        return c

    def gauge(self, name: str, size: int = 1) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(size)
        return g

    # -- queries -------------------------------------------------------------
    def percentiles(self, name: str, qs: Sequence[float] = (50, 95, 99),
                    node: Optional[int] = None,
                    category: Optional[int] = None) -> dict:
        """p-summary for one series; None label = aggregate across it."""
        if node is not None and category is not None:
            h = self._hists.get((name, node, category))
        elif node is None and category is None:
            h = self._hists.get((name, -1, -1))
        else:  # one side fixed: exact merge over the free label
            h = Histogram()
            for (n, nd, ct), src in self._hists.items():
                if n != name or nd == -1 and ct == -1:
                    continue
                if (node is None or nd == node) and \
                        (category is None or ct == category):
                    h.merge(src)
        if h is None or h.n == 0:
            return {f"p{g:g}": math.nan for g in qs} | {"n": 0}
        return h.percentiles(qs) | {"n": h.n, "mean": h.mean}

    def summary(self, names: Optional[Iterable[str]] = None,
                qs: Sequence[float] = (50, 95, 99)) -> dict:
        """{name: p-summary} for the global series of each metric name."""
        if names is None:
            names = sorted({k[0] for k in self._hists})
        return {n: self.percentiles(n, qs) for n in names
                if (n, -1, -1) in self._hists}

    def labels(self, name: str) -> list:
        """All (node, category) label pairs recorded for ``name``."""
        return sorted((nd, ct) for (n, nd, ct) in self._hists
                      if n == name and not (nd == -1 and ct == -1))

    def counters(self) -> dict:
        return {n: c.values.copy() for n, c in self._counters.items()}

    def gauges(self) -> dict:
        return {n: g.values.copy() for n, g in self._gauges.items()}
