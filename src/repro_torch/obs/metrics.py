"""Fixed-edge log histogram on numpy (the port of ``repro.obs.metrics``,
pruned to :class:`Histogram`: the counters, gauges and the metrics registry
come with the serving fleet, ROADMAP.md Queue 1 item 11).

Every histogram shares one set of log-spaced bucket edges, so percentiles
come from bucket counts and two histograms of one metric merge exactly by
summing their counts.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from typing import Sequence

import numpy as np

__all__ = ["BUCKET_LO", "BUCKET_HI", "N_BUCKETS", "Histogram"]

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
