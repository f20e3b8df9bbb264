"""Monitoring module (paper §IV-B.6: q_j "obtained from the monitoring
module"; §VI future work: "real-time monitoring mechanisms for node and model
status, coupled with fault-tolerant strategies").

Tracks, per node: outstanding request count (the q_j feature), health state
with heartbeat expiry and a circuit breaker, and EWMA latency per node
used for straggler detection (hedging threshold) by the cluster server.

Beyond that, the monitor is the **drift sensor** for the rolling-horizon
re-optimization loop (``core.router.maybe_reoptimize``): each completion
updates a fast and a slow EWMA of observed latency; a sustained gap between
them means the workload/queueing regime has shifted away from the window the
current policy was optimized on, and :meth:`drift_score` quantifies that
shift as a relative latency change (0 = stationary).

Clock discipline: every method that touches time takes an explicit ``now`` so
the same code runs under a simulated clock and in wall-clock serving.
Heartbeats are initialized to the construction time — a node that has
*never* heartbeated is not considered stale until a full
``heartbeat_timeout`` has elapsed since construction.

The monitor also holds the live state two router inputs read: the
prefix-cache state of cache-affinity routing (which session and system
prompt prefixes each node holds) and the optional online estimator of the
learned-estimator loop (:meth:`feed_estimator`).

A copy of ``repro.cluster.monitor`` (the port imports nothing of
``repro``): the serving fleet's hooks (``on_cancel``,
``record_fleet``, ``fleet_totals``, ``straggler_threshold``) and the
metrics registry the monitor owns included. Its state after a
sequence of events must equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..learn import OnlineEstimator
from ..obs.metrics import MetricsRegistry


@dataclasses.dataclass
class NodeStats:
    outstanding: int = 0
    total_dispatched: int = 0
    total_completed: int = 0
    total_failed: int = 0
    total_cancelled: int = 0
    healthy: bool = True
    last_heartbeat: float = 0.0
    ewma_latency: float = 0.0
    ewma_alpha: float = 0.2
    # seeded on the FIRST completion (whatever its latency, zero included);
    # the old ``ewma or latency`` idiom re-seeded whenever the EWMA happened
    # to be exactly 0.0
    ewma_initialized: bool = False
    # drift sensing: fast tracker vs slow baseline of the same signal
    ewma_fast: float = 0.0
    ewma_slow: float = 0.0
    alpha_fast: float = 0.3
    alpha_slow: float = 0.03
    # prefix-cache state: (kind, group) -> cached prefix tokens on this node,
    # where kind is "sess" (one session's latest prompt) or "sys" (a shared
    # system prompt). The cache-affinity router reads this to estimate the
    # cached-prefix fraction per candidate node.
    cached_prefixes: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict)
    # circuit breaker (closed -> open on error-rate EWMA, open -> half-open
    # after a cooldown, half-open admits ONE probe whose outcome decides
    # closed vs re-open). Inert unless the monitor was built with
    # ``breaker_threshold``.
    breaker_state: str = "closed"
    err_ewma: float = 0.0
    err_obs: int = 0
    breaker_opened_at: float = 0.0
    probe_inflight: bool = False


class ClusterMonitor:
    """Thread-light monitor; all methods take an explicit ``now`` so the same
    code runs under the discrete-event simulator and in wall-clock serving."""

    def __init__(self, n_nodes: int, heartbeat_timeout: float = 10.0,
                 now: float = 0.0,
                 metrics: Optional[MetricsRegistry] = None,
                 breaker_threshold: Optional[float] = None,
                 breaker_alpha: float = 0.3, breaker_min_obs: int = 4,
                 breaker_cooldown: float = 20.0,
                 estimator: Optional[OnlineEstimator] = None):
        self.stats: Dict[int, NodeStats] = {
            j: NodeStats(last_heartbeat=now) for j in range(n_nodes)}
        self.heartbeat_timeout = heartbeat_timeout
        # the monitor's own clock: every caller advances it explicitly
        # (simulated seconds under the DES, scheduler ticks when serving)
        # via :meth:`advance` — heartbeats, staleness expiry, and breaker
        # cooldowns all live in this ONE domain, never mixed with wall time
        self.now = now
        # per-node circuit breakers: disabled unless a threshold is given
        # (error-rate EWMA >= threshold after >= min_obs observations opens
        # the breaker; after ``breaker_cooldown`` clock units it admits one
        # half-open probe whose outcome decides closed vs re-open)
        self.breaker_threshold = breaker_threshold
        self.breaker_alpha = breaker_alpha
        self.breaker_min_obs = breaker_min_obs
        self.breaker_cooldown = breaker_cooldown
        # all monitor series live in one queryable MetricsRegistry (shared
        # with the scheduler's when serving; private otherwise)
        self.metrics = MetricsRegistry() if metrics is None else metrics
        # fleet counters: per-node emitted-token / retired-slot totals fed in
        # one vectorized update per cohort dispatch from the stacked
        # (member, n, 3, B) chunk output — no per-engine host pulls. Backed
        # by registry CounterVecs so fleet_totals() and metrics_flat() read
        # the same storage.
        self.fleet_emitted = self.metrics.counter(
            "fleet_tokens_emitted", n_nodes).values
        self.fleet_retired = self.metrics.counter(
            "fleet_slots_retired", n_nodes).values
        self.breaker_opens = self.metrics.counter(
            "breaker_open_total", n_nodes).values
        # optional online-learned estimator (repro_torch.learn): the live third
        # leg of the learned-estimator loop — the router reads its residual
        # predictions on the hot path, completion observations feed it via
        # :meth:`feed_estimator`
        self.estimator = estimator

    # -- data plane callbacks -------------------------------------------------
    def on_dispatch(self, node: int) -> None:
        s = self.stats[node]
        s.outstanding += 1
        s.total_dispatched += 1
        # the first dispatch into a half-open breaker is its probe; until
        # it resolves, healthy_mask hides the node again
        if s.breaker_state == "half-open" and not s.probe_inflight:
            s.probe_inflight = True

    def on_complete(self, node: int, latency: float) -> None:
        s = self.stats[node]
        s.outstanding = max(0, s.outstanding - 1)
        s.total_completed += 1
        if not s.ewma_initialized:
            # seed all trackers on the first observation — 0.0 is a
            # legitimate first latency and must not leave them unseeded
            s.ewma_latency = s.ewma_fast = s.ewma_slow = latency
            s.ewma_initialized = True
        else:
            s.ewma_latency = (s.ewma_alpha * latency
                              + (1 - s.ewma_alpha) * s.ewma_latency)
            s.ewma_fast = (s.alpha_fast * latency
                           + (1 - s.alpha_fast) * s.ewma_fast)
            s.ewma_slow = (s.alpha_slow * latency
                           + (1 - s.alpha_slow) * s.ewma_slow)
        self.metrics.observe("latency", latency, node=node)
        self._breaker_observe(node, 0.0)

    def on_failure(self, node: int) -> None:
        s = self.stats[node]
        s.outstanding = max(0, s.outstanding - 1)
        s.total_failed += 1
        self._breaker_observe(node, 1.0)

    def on_cancel(self, node: int) -> None:
        """A dispatched request was cancelled (e.g. a hedged duplicate lost
        the race): close its accounting without counting it as served."""
        s = self.stats[node]
        s.outstanding = max(0, s.outstanding - 1)
        s.total_cancelled += 1

    def record_fleet(self, nodes, emitted, retired) -> None:
        """Accumulate per-node decode progress from one cohort dispatch.

        ``nodes``/``emitted``/``retired`` are parallel arrays over the
        cohort's members (a node hosting several member engines accumulates
        via ``np.add.at``). Called once per stacked dispatch — the fleet
        counterpart of per-request ``on_complete`` accounting."""
        np.add.at(self.fleet_emitted, np.asarray(nodes, np.int64),
                  np.asarray(emitted, np.int64))
        np.add.at(self.fleet_retired, np.asarray(nodes, np.int64),
                  np.asarray(retired, np.int64))

    def fleet_totals(self) -> Dict[str, int]:
        return {"emitted": int(self.fleet_emitted.sum()),
                "retired": int(self.fleet_retired.sum())}

    def heartbeat(self, node: int, now: float) -> None:
        """Mark ``node`` alive at ``now`` (the caller's clock).

        ``now`` is required: the pre-clock-discipline silent
        ``time.monotonic()`` fallback mixed wall clock into simulated-tick
        runs, poisoning ``sweep`` expiry. It survived one release as a
        DeprecationWarning shim and has been removed — wall-clock callers
        pass ``heartbeat(node, now=time.monotonic())`` explicitly.
        """
        s = self.stats[node]
        s.last_heartbeat = now
        s.healthy = True

    def feed_estimator(self, category: int, node_p: int, node_q: int,
                       prompt_tokens: float, complexity: float,
                       y_prefill: float, y_tpot: float,
                       y_quality: float = 0.0) -> None:
        """Forward one completed request's residual targets into the
        attached :class:`~repro_torch.learn.OnlineEstimator` (no-op without one).

        ``y_*`` are residual targets computed by the caller in its own clock
        domain — typically ``OnlineEstimator.ratio(expected, realized)`` for
        the latency signals; decision-time queue depths come from this
        monitor's outstanding counts."""
        if self.estimator is None:
            return
        self.estimator.observe(
            category, node_p, node_q, prompt_tokens, complexity,
            np.asarray(self.queue_lengths(), np.int64),
            self.estimator.node_conc, y_prefill, y_tpot, y_quality)

    def mark_down(self, node: int) -> None:
        self.stats[node].healthy = False

    def sweep(self, now: float) -> None:
        """Expire nodes whose heartbeat is stale."""
        for s in self.stats.values():
            if now - s.last_heartbeat > self.heartbeat_timeout:
                s.healthy = False

    def advance(self, now: float) -> None:
        """Advance the monitor's clock to ``now`` (the caller's domain —
        scheduler ticks or simulated seconds): expires stale heartbeats and
        moves cooled-down open breakers to half-open (one probe admitted).
        The one clock entry point a periodic caller needs."""
        self.now = now
        self.sweep(now)
        if self.breaker_threshold is None:
            return
        for s in self.stats.values():
            if (s.breaker_state == "open"
                    and now - s.breaker_opened_at >= self.breaker_cooldown):
                s.breaker_state = "half-open"
                s.probe_inflight = False

    # -- circuit breakers ------------------------------------------------------
    def _breaker_observe(self, node: int, err: float) -> None:
        """Feed one request outcome (0 = success, 1 = failure) into the
        node's breaker state machine. No-op when breakers are disabled."""
        if self.breaker_threshold is None:
            return
        s = self.stats[node]
        s.err_ewma = (self.breaker_alpha * err
                      + (1 - self.breaker_alpha) * s.err_ewma)
        s.err_obs += 1
        if s.breaker_state == "half-open":
            if err > 0:                      # the probe failed: re-open
                s.breaker_state = "open"
                s.breaker_opened_at = self.now
                s.probe_inflight = False
                self.breaker_opens[node] += 1
            else:                            # the probe succeeded: close
                s.breaker_state = "closed"
                s.err_ewma = 0.0
                s.err_obs = 0
                s.probe_inflight = False
        elif (s.breaker_state == "closed" and err > 0
              and s.err_obs >= self.breaker_min_obs
              and s.err_ewma >= self.breaker_threshold):
            s.breaker_state = "open"
            s.breaker_opened_at = self.now
            self.breaker_opens[node] += 1

    def reset_breaker(self, node: int) -> None:
        """Explicit recovery (``ClusterServer.recover_node``): close the
        breaker and forget its error history."""
        s = self.stats[node]
        s.breaker_state = "closed"
        s.err_ewma = 0.0
        s.err_obs = 0
        s.probe_inflight = False

    def breaker_states(self) -> Tuple[str, ...]:
        return tuple(self.stats[j].breaker_state for j in sorted(self.stats))

    # -- prefix-cache state (cache-affinity routing) ---------------------------
    def record_prefix(self, node: int, key: Tuple[str, int],
                      tokens: int) -> None:
        """A prompt prefix of ``tokens`` tokens is now cached on ``node``
        (monotone max: sessions only ever extend their prompts)."""
        cp = self.stats[node].cached_prefixes
        cp[key] = max(cp.get(key, 0), int(tokens))

    def cached_tokens(self, node: int, key: Tuple[str, int]) -> int:
        return self.stats[node].cached_prefixes.get(key, 0)

    def drop_prefixes(self, node: int) -> None:
        """Node restart / cache flush: forget its prefix state."""
        self.stats[node].cached_prefixes.clear()

    def hit_fractions(self, session: int, sys: int, prompt_tokens: float,
                      sys_tokens: float, block: int = 16) -> Tuple[float, ...]:
        """Expected cached-prefix fraction of this prompt per node.

        Whole-block granularity (the paged pool shares only full blocks);
        the session's own cached prompt dominates the shared system prompt
        when both are resident."""
        blk_p = (int(prompt_tokens) // block) * block
        blk_s = (int(sys_tokens) // block) * block
        out = []
        for j in sorted(self.stats):
            hit = 0
            if session >= 0:
                hit = min(self.cached_tokens(j, ("sess", session)), blk_p)
            if sys >= 0:
                hit = max(hit, min(self.cached_tokens(j, ("sys", sys)),
                                   blk_s))
            out.append(hit / max(float(prompt_tokens), 1.0))
        return tuple(out)

    # -- router-facing views ---------------------------------------------------
    def queue_lengths(self) -> Tuple[int, ...]:
        return tuple(self.stats[j].outstanding for j in sorted(self.stats))

    def healthy_mask(self) -> Tuple[bool, ...]:
        """Routable nodes: heartbeat-healthy AND breaker not open (a
        half-open breaker exposes the node only until its probe departs)."""
        def ok(s: NodeStats) -> bool:
            if not s.healthy or s.breaker_state == "open":
                return False
            return not (s.breaker_state == "half-open" and s.probe_inflight)
        return tuple(ok(self.stats[j]) for j in sorted(self.stats))

    def straggler_threshold(self, node: int, factor: float = 3.0) -> float:
        """Hedge a request if it exceeds factor × EWMA latency of its node."""
        base = self.stats[node].ewma_latency
        return factor * base if base > 0 else float("inf")

    def drift_score(self) -> float:
        """Max over nodes of the relative fast-vs-slow EWMA latency gap.

        ~0 while the workload is stationary; grows toward |Δ|/baseline when
        recent latencies diverge from the long-run level (arrival burst, mix
        shift, slow node). The router's re-optimization trigger compares this
        against a threshold (see ``RequestRouter.should_reoptimize``).
        """
        score = 0.0
        for s in self.stats.values():
            if s.ewma_slow > 0:
                score = max(score,
                            abs(s.ewma_fast - s.ewma_slow) / s.ewma_slow)
        return score

    def rebaseline_drift(self) -> None:
        """Re-arm the drift detector: snap the slow baseline to the current
        fast tracker. Called after a re-optimization installs a new policy,
        so one regime shift triggers one re-fit instead of firing on every
        subsequent check until the slow EWMA reconverges (~1/alpha_slow
        completions)."""
        for s in self.stats.values():
            s.ewma_slow = s.ewma_fast
