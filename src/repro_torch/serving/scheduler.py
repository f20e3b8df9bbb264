"""Cluster-level serving: NSGA-II-routed dispatch across real LLM engines.

``ClusterServer`` is the end-to-end data plane: it instantiates one
``LLMEngine`` per (node, model) pair of a ``ClusterSpec`` (dense LMs of
``models.lm`` on the card, unless the caller asks for the CPU), routes each
incoming request through the paper's runtime router (Algorithm 2 +
failover), and drives all engines' continuous-batching loops — with
``fleet=True`` (the default), engines sharing a model decode as one batch
(``serving.fleet``). Beyond-paper fault tolerance:

* **node failure** — ``fail_node`` marks a node down; its in-flight requests
  are re-queued and re-routed; the monitor masks it from Algorithm 2 until
  ``recover_node``;
* **disaggregated prefill/decode** — when the router runs a route-valued
  policy (``mode="disagg"``) and picks a split route, the prefill leg runs
  via ``LLMEngine.prefill_only`` on the prefill-role node, the exported KV
  rides a **transfer-in-flight queue** for ``ceil(link_seconds /
  tick_seconds)`` ticks, and delivery imports the blocks into the decode
  engine's paged pool so admission reuses them bit-identically. Either
  endpoint dying mid-handoff aborts the transfer (export pins released /
  gone with the dead pool), closes the prefill leg's accounting, and
  re-routes the request with a full re-prefill;
* **straggler hedging** — a request whose engine has run more than
  ``hedge_after`` iterations beyond the node's EWMA issues a duplicate on
  the router's backup pair; first completion wins, the loser is **cancelled**
  (``LLMEngine.cancel``) and its dispatch accounting closed via
  ``monitor.on_cancel`` — queue lengths drain back to zero, so hedging never
  skews later queue-based routing decisions;
* **chaos hardening** — an optional ``faults.FaultSchedule`` replays
  deterministic crash windows, stragglers (executed-iteration slow-credit),
  KV-link flaps, heartbeat losses, and transient dispatch errors against the
  runtime, and a ``ResilienceConfig`` arms deadline-aware timeouts with
  budgeted jittered retries, per-node circuit breakers (``ClusterMonitor``),
  and SLO-class load shedding on admission.

The server keeps a simulated clock (``self.ticks``, one unit per ``step``)
and feeds it to every monitor call that takes a timestamp, so heartbeat /
sweep bookkeeping stays in scheduler time rather than leaking wall-clock
``time.monotonic()`` into simulated runs.

The port of ``repro.serving.scheduler``: with the same weights (f32) and
requests, its served tokens, tick latencies and ``stats()`` equal the
reference server's, fleet on and off. It is numpy over engines; the device
work is the engines' and cohorts'.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .._device import Device, resolve
from ..cluster.monitor import ClusterMonitor
from ..cluster.spec import ClusterSpec
from ..core.router import RequestRouter
from ..faults import (FaultSchedule, backoff_jitter_u, heartbeat_lost,
                      link_slowdown_np, node_available_np, node_slowdown_np,
                      transient_hit_np)
from ..learn import OnlineEstimator
from ..obs import Obs
from ..workload.datasets import Request
from .engine import EngineConfig, LLMEngine
from .fleet import Cohort, build_cohorts

PROMPT_CAP = 24   # the server's tokenizer keeps at most this many words


def tokenize(req: Request, vocab: int,
             cap: Optional[int] = None) -> np.ndarray:
    """Deterministic, **prefix-stable** word-level tokenization.

    Each whitespace word hashes independently via ``zlib.crc32`` (stable
    across processes, unlike the salted ``hash()``) and prefix-preserving: a
    prompt that textually extends another maps to a token stream extending
    the other's, which is what lets the engine's paged KV cache reuse
    earlier turns of a session. It never pads past the real words; only an
    empty prompt gets a single placeholder token. ``cap`` bounds the length
    (None keeps every word; the server passes ``PROMPT_CAP``)."""
    words = req.text.split()
    n = min(max(4, req.prompt_tokens), len(words))
    if cap is not None:
        n = min(n, cap)
    toks = [zlib.crc32(w.encode()) % vocab for w in words[:n]]
    if not toks:
        toks = [zlib.crc32(b"<empty>") % vocab]
    return np.asarray(toks, np.int32)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the server's retry / breaker / shedding machinery.

    Timeouts and backoffs are in scheduler ticks. A request times out after
    ``min(request_timeout_ticks, deadline_timeout_factor * ttft_slo /
    tick_seconds)`` iterations of aging (deadline-aware: interactive SLO
    classes give up and retry sooner than batch ones), is retried at most
    ``max_retries`` times with deterministic exponential backoff
    (``backoff_base_ticks * backoff_mult**attempt``, counter-hash jitter —
    same stream as the analytic layers' ``faults.backoff_jitter_u``), and
    every retry draws on a **global budget** of ``max(retry_budget_min,
    retry_budget_frac * total_dispatches)`` so a mass failure degrades to
    slow-but-bounded instead of a retry storm. ``shed_threshold`` /
    ``shed_interactive_threshold`` are cluster-utilization fractions
    (queued+active over total slots) above which ``submit`` sheds batch-class
    and then all requests. ``breaker_threshold`` feeds the monitor's per-node
    circuit breakers (error-rate EWMA; ``None`` disables them)."""

    request_timeout_ticks: int = 200
    deadline_timeout_factor: float = 8.0
    min_timeout_ticks: int = 24
    max_retries: int = 2
    backoff_base_ticks: float = 2.0
    backoff_mult: float = 2.0
    jitter: float = 0.5
    jitter_seed: int = 0x5EED5EED
    retry_budget_frac: float = 0.2
    retry_budget_min: int = 8
    shed_threshold: float = 0.9
    shed_interactive_threshold: float = 1.5
    breaker_threshold: Optional[float] = 0.5
    breaker_cooldown_ticks: float = 50.0


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    req: Request
    max_new_tokens: int = 8
    slo_class: str = "interactive"   # "interactive" | "batch" (shed order)


@dataclasses.dataclass
class _Flight:
    sreq: ServeRequest
    pair: int
    iters: int = 0
    hedge_pair: Optional[int] = None
    depart_tick: int = 0   # scheduler tick of the (original) dispatch
    category: int = -1     # classifier category at routing (metrics label)
    est_cost: float = 0.0  # modelled $ of the routed pair (spend metric)
    attempt: int = 0       # 0 = first dispatch; bumps on each timeout retry
    timeout_ticks: float = float("inf")   # deadline-aware per-request timeout
    # learned-estimator feedback: the estimates the routing decision acted
    # on (0 = policy never requested estimate rows -> nothing to learn) and
    # the decision-time features; the prefill residual attributes to
    # ``prefill_node`` on disaggregated routes (-1 = colocated)
    est_ttft: float = 0.0
    est_tpot: float = 0.0
    complexity: float = 0.0
    prefill_node: int = -1


@dataclasses.dataclass
class _Transfer:
    """A KV handoff in flight between a prefill-role and a decode-role node.

    The payload is host-copied at departure, but delivery is gated on the
    ETA tick *and* both endpoints staying alive: either endpoint dying
    mid-transfer aborts the handoff and the request re-routes with a full
    re-prefill (``ClusterServer.fail_node``)."""

    sreq: ServeRequest
    prefill_pair: int
    decode_pair: int
    block_ids: list
    tokens: np.ndarray
    n_cov: int                 # whole-block tokens covered by the payload
    payload: object            # host K/V slabs (kvcache.export_blocks)
    depart_tick: int
    eta: int
    category: int = -1         # classifier category (metrics label)
    est_cost: float = 0.0      # modelled $ of the decode pair (spend metric)
    # learned-estimator feedback carried through to the decode-side _Flight
    est_ttft: float = 0.0
    est_tpot: float = 0.0
    complexity: float = 0.0


class ClusterServer:
    def __init__(self, cluster: ClusterSpec, model_builders: Dict[str, tuple],
                 thresholds, engine_cfg: EngineConfig = EngineConfig(),
                 hedge_after: int = 64,
                 router_kwargs: Optional[dict] = None,
                 tick_seconds: float = 0.05, fleet: bool = True,
                 obs: Optional[Obs] = None,
                 faults: Optional[FaultSchedule] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 device: Device = None):
        """model_builders: model name -> (ModelConfig, ``models.lm.LM``);
        names sharing one ``LM`` object give engines that can share a
        cohort.
        router_kwargs: extra RequestRouter arguments (e.g.
        ``mode="affinity"`` for cache-affinity dispatch).
        fleet: group engines sharing a (ModelConfig, EngineConfig, model)
        identity into cohorts (``serving.fleet``) so each cohort decodes in
        ONE dispatch over all its rows per tick; ``False`` keeps the
        per-engine Python loop (the same results, O(#engines) dispatches).
        obs: optional ``obs.Obs`` telemetry bundle — lifecycle spans
        on the scheduler-tick clock, the shared metrics registry, and the
        router decision audit. Defaults to ``Obs.noop()``: no span/audit
        recording, but the metrics registry (always owned by the monitor)
        still feeds ``stats()['percentiles']``.
        faults: optional ``faults.FaultSchedule`` replayed against the
        runtime with times in **scheduler ticks** — crash windows fail/recover
        nodes, stragglers slow their decode rate, link flaps stretch KV
        handoffs, heartbeat losses go telemetry-dark, transient errors bounce
        dispatches into the retry path. The same schedule drives the DES
        oracles and the fitness scan, so a genome tuned under it is tested
        here against the identical regime.
        resilience: retry / breaker / shedding knobs (``ResilienceConfig``);
        defaults on when ``faults`` is given, otherwise off.
        device: where the engines run (and the router's re-fit): CUDA
        unless the caller asks for another device."""
        self.device = resolve(device)
        self.cluster = cluster
        self.obs = Obs.noop() if obs is None else obs
        self.tracer = self.obs.tracer
        if faults is not None and resilience is None:
            resilience = ResilienceConfig()
        self.resilience = resilience
        self.fault_schedule = faults
        self._fault_tables = (faults.compile(len(cluster.nodes))
                              if faults is not None else None)
        self.monitor = ClusterMonitor(
            len(cluster.nodes), metrics=self.obs.metrics,
            breaker_threshold=(None if resilience is None
                               else resilience.breaker_threshold),
            breaker_cooldown=(20.0 if resilience is None
                              else resilience.breaker_cooldown_ticks))
        self.metrics = self.monitor.metrics  # always a live registry
        rkw = dict(router_kwargs or {})
        rkw.setdefault("audit", self.obs.audit)
        rkw.setdefault("device", self.device)
        self.router = RequestRouter(cluster, thresholds, monitor=self.monitor,
                                    **rkw)
        self.engines: Dict[int, LLMEngine] = {}
        self.pair_model_cfg: Dict[int, object] = {}
        for p, (j, k) in enumerate(cluster.pairs()):
            name = cluster.models[k].name
            mcfg, model = model_builders[name]
            self.engines[p] = LLMEngine(mcfg, model, engine_cfg,
                                        device=self.device)
            self.pair_model_cfg[p] = mcfg
        self.fleet = fleet
        self._cohorts: List[Cohort] = []
        self._cohort_pairs: List[List[int]] = []
        self._pair_cohort: Dict[int, tuple] = {}
        self._cohort_nodes: List[np.ndarray] = []
        if fleet:
            self._cohorts, self._cohort_pairs, self._pair_cohort = \
                build_cohorts(self.engines)
            pair_node = self.router.arrays.pair_node
            self._cohort_nodes = [
                np.asarray([pair_node[p] for p in pairs], np.int64)
                for pairs in self._cohort_pairs]
        # per-cohort stacked-dispatch participation (host-side counter: the
        # dispatch result already carries the count, no extra device sync)
        self._cohort_part = self.metrics.counter(
            "cohort_participants", max(len(self._cohorts), 1))
        self.inflight: Dict[int, _Flight] = {}
        self.transfers: Dict[int, _Transfer] = {}   # KV handoffs in flight
        self.done: Dict[int, dict] = {}
        self.hedge_after = hedge_after
        self.tick_seconds = tick_seconds   # converts KV-link seconds -> ticks
        self._hedges = 0
        self._reroutes = 0
        self._handoffs = 0
        self.ticks = 0   # simulated scheduler clock: one unit per step()
        # resilience state. _down_nodes is the liveness ground truth for
        # engine progress (a breaker-open or telemetry-dark node is routing-
        # masked but its engines keep executing); _fault_down tracks which of
        # those crashes the schedule caused, so schedule-window exits recover
        # only them and never a manually failed node.
        self._down_nodes: set = set()
        self._fault_down: set = set()
        self._slow_credit = np.zeros(len(cluster.nodes))
        self._advance = np.ones(len(cluster.nodes), bool)
        self._transient_done: set = set()   # rids whose transient fault fired
        self._retry_queue: Dict[int, Tuple[int, ServeRequest, int]] = {}
        self._retries_spent = 0
        self._timeouts = 0
        self._transients = 0
        self._sheds = 0
        self._capacity = max(1, engine_cfg.max_slots * len(self.engines))

    # -- resilience helpers ----------------------------------------------------
    def _timeout_ticks(self, cat: int) -> float:
        """Deadline-aware timeout: the configured ceiling, tightened to a
        multiple of the category's TTFT SLO (converted seconds -> ticks) when
        the router carries one — interactive classes give up and retry long
        before a batch request would."""
        rcfg = self.resilience
        if rcfg is None:
            return float("inf")
        t = float(rcfg.request_timeout_ticks)
        slo = getattr(self.router, "_slo_ttft", None)
        if slo is not None and 0 <= cat < len(slo):
            dl = float(np.asarray(slo)[cat])
            if np.isfinite(dl):
                t = min(t, max(float(rcfg.min_timeout_ticks),
                               rcfg.deadline_timeout_factor * dl
                               / self.tick_seconds))
        return t

    def _retry_budget_ok(self) -> bool:
        """Global anti-storm budget: total retries so far must stay under a
        fraction of total dispatches (with a floor so a cold cluster can
        still retry at all)."""
        rcfg = self.resilience
        total = sum(s.total_dispatched for s in self.monitor.stats.values())
        budget = max(rcfg.retry_budget_min,
                     int(rcfg.retry_budget_frac * total))
        return self._retries_spent < budget

    def _schedule_retry(self, sreq: ServeRequest, attempt: int) -> None:
        """Queue a retry after deterministic exponential backoff with
        counter-hash jitter — same ``backoff_jitter_u`` stream the analytic
        layers use, so a replayed schedule reproduces the exact retry times."""
        rcfg = self.resilience
        self._retries_spent += 1
        u = backoff_jitter_u(rcfg.jitter_seed, sreq.request_id, attempt)
        back = rcfg.backoff_base_ticks * (rcfg.backoff_mult ** attempt)
        due = self.ticks + max(1, int(round(back * (1.0 + rcfg.jitter * u))))
        self._retry_queue[sreq.request_id] = (due, sreq, attempt + 1)

    def _fault_tick(self) -> None:
        """Replay this tick's slice of the fault schedule and advance the
        monitor clock. Crash-window entries ``fail_node`` (once), exits
        ``recover_node`` only schedule-crashed nodes; every live node then
        auto-heartbeats unless its heartbeat is schedule-lost (node alive,
        telemetry dark -> staleness masks it from routing while its engines
        keep running); ``monitor.advance`` runs the staleness sweep and
        breaker cooldowns on the tick clock. Straggler slowdown integrates
        **slow-credit**: a node at factor s earns 1/s credit per tick and its
        engines execute a decode iteration only on ticks where credit >= 1 —
        executed-iteration scaling, the runtime twin of the oracles'
        service-time scaling."""
        n = len(self.cluster.nodes)
        t = np.float32(self.ticks)
        ft = self._fault_tables
        if ft is not None:
            avail = node_available_np(ft, t)
            for node in range(n):
                if not avail[node] and node not in self._down_nodes:
                    self._fault_down.add(node)
                    self.fail_node(node)
                elif avail[node] and node in self._fault_down:
                    self.recover_node(node)
        for node in range(n):
            if node in self._down_nodes:
                continue
            if (self.fault_schedule is not None
                    and heartbeat_lost(self.fault_schedule, node, float(t))):
                continue
            self.monitor.heartbeat(node, now=self.ticks)
        self.monitor.advance(float(self.ticks))
        if ft is not None:
            slow = node_slowdown_np(ft, t)
            self._slow_credit += 1.0 / np.maximum(slow, 1.0)
            adv = self._slow_credit >= 1.0 - 1e-9
            self._slow_credit[adv] -= 1.0
            self._advance = adv

    # -- helpers ---------------------------------------------------------------
    def _tokenize(self, req: Request, vocab: int,
                  cap: int = PROMPT_CAP) -> np.ndarray:
        """The server's tokenizer (:func:`tokenize`)."""
        return tokenize(req, vocab, cap)

    def _dispatch(self, sreq: ServeRequest, pair: int):
        eng = self.engines[pair]
        mcfg = self.pair_model_cfg[pair]
        eng.submit(sreq.request_id, self._tokenize(sreq.req, mcfg.vocab),
                   max_new_tokens=sreq.max_new_tokens)
        node = int(self.router.arrays.pair_node[pair])
        self.monitor.on_dispatch(node)
        # span event mirrors the monitor accounting call one-for-one
        self.tracer.event(sreq.request_id, "dispatch", self.ticks,
                          node=node, pair=pair)
        # keep the monitor's prefix-cache view in sync with what this node's
        # engine now holds (cache-affinity routing reads it)
        req = sreq.req
        blk = self.router.cache_block
        sid = getattr(req, "session_id", -1)
        if sid >= 0:
            self.monitor.record_prefix(
                node, ("sess", sid), int(req.prompt_tokens) // blk * blk)
        yid = getattr(req, "sys_id", -1)
        if yid >= 0:
            self.monitor.record_prefix(
                node, ("sys", yid),
                int(getattr(req, "sys_tokens", 0)) // blk * blk)

    def _start_handoff(self, sreq: ServeRequest, prefill_pair: int,
                       decode_pair: int, category: int = -1,
                       est_cost: float = 0.0, est_ttft: float = 0.0,
                       est_tpot: float = 0.0,
                       complexity: float = 0.0) -> bool:
        """Disaggregated dispatch: run the prefill leg now, put the exported
        KV on the transfer-in-flight queue. Returns False when the route
        cannot hand off (no paged stores, same node, or nothing block-aligned
        to ship) — the caller then serves the request colocated on the decode
        pair with a full prefill."""
        eng_p = self.engines[prefill_pair]
        eng_q = self.engines[decode_pair]
        arr = self.router.arrays
        node_p = int(arr.pair_node[prefill_pair])
        node_q = int(arr.pair_node[decode_pair])
        if eng_p.kv is None or eng_q.kv is None or node_p == node_q:
            return False
        mcfg = self.pair_model_cfg[decode_pair]
        tokens = self._tokenize(sreq.req, mcfg.vocab)
        bs = eng_p.kv.block_size
        if len(tokens) < bs:
            return False   # no whole block to ship
        self.monitor.on_dispatch(node_p)
        self.tracer.event(sreq.request_id, "dispatch", self.ticks,
                          node=node_p, pair=prefill_pair)
        block_ids = eng_p.prefill_only(sreq.request_id, tokens)
        n_cov = len(block_ids) * bs
        if not block_ids:
            # pool exhausted before the first block: close the prefill leg
            # and fall back to a colocated full prefill
            self.monitor.on_cancel(node_p)
            self.tracer.event(sreq.request_id, "cancel", self.ticks,
                              node=node_p)
            return False
        payload = eng_p.export_kv(block_ids)
        kv_bytes = float(n_cov) * float(arr.pair_kv_bytes_per_token[
            prefill_pair])
        tt = float(arr.kv_lat[node_p, node_q]) + \
            kv_bytes * float(arr.kv_inv_bw[node_p, node_q])
        if self._fault_tables is not None:
            # a degraded/flapping KV link stretches the transfer in flight
            tt *= float(link_slowdown_np(self._fault_tables,
                                         np.float32(self.ticks)))
        ticks = max(1, int(np.ceil(tt / self.tick_seconds)))
        self.transfers[sreq.request_id] = _Transfer(
            sreq=sreq, prefill_pair=prefill_pair, decode_pair=decode_pair,
            block_ids=block_ids, tokens=tokens, n_cov=n_cov, payload=payload,
            depart_tick=self.ticks, eta=self.ticks + ticks,
            category=category, est_cost=est_cost, est_ttft=est_ttft,
            est_tpot=est_tpot, complexity=complexity)
        self._handoffs += 1
        self.tracer.event(sreq.request_id, "handoff-start", self.ticks,
                          node=node_p, decode_node=node_q,
                          eta=self.ticks + ticks)
        return True

    def _route_dispatch(self, sreq: ServeRequest, iters: int = 0,
                        attempt: int = 0):
        """Route one request and dispatch it — colocated into an engine, or
        through the KV-handoff pipeline when a route-valued policy split the
        (prefill, decode) legs across nodes. ``attempt`` counts timeout
        retries of this request (aging restarts; the retry keeps its span)."""
        decision = self.router.route(sreq.req)
        cat = int(decision.features[1])
        self.tracer.set_category(sreq.request_id, cat)
        self.tracer.event(sreq.request_id, "route-decision", self.ticks,
                          pair=decision.pair, node=decision.node,
                          prefill_pair=decision.prefill_pair)
        rcfg = self.resilience
        ft = self._fault_tables
        if (ft is not None and rcfg is not None
                and float(ft.err_rate) > 0.0
                and sreq.request_id not in self._transient_done
                and transient_hit_np(ft, sreq.request_id)):
            # deterministic transient dispatch error (same counter-hash draw
            # as the analytic layers' per-request delay): charge one failed
            # dispatch to the routed node — breaker food — and bounce the
            # request into the backoff/retry queue. Fires at most once per
            # request, mirroring the oracles' one-shot delay semantics.
            self._transient_done.add(sreq.request_id)
            self._transients += 1
            node = decision.node
            self.monitor.on_dispatch(node)
            self.monitor.on_failure(node)
            self.tracer.event(sreq.request_id, "failure", self.ticks,
                              node=node, transient=True)
            if attempt < rcfg.max_retries:
                self._schedule_retry(sreq, attempt)
            else:
                self.tracer.end(sreq.request_id, self.ticks, "failed")
                self.done[sreq.request_id] = {"status": "failed"}
            return decision
        if (decision.prefill_pair is not None
                and decision.prefill_pair != decision.pair
                and self._start_handoff(sreq, decision.prefill_pair,
                                        decision.pair, category=cat,
                                        est_cost=decision.est_cost,
                                        est_ttft=decision.est_ttft,
                                        est_tpot=decision.est_tpot,
                                        complexity=float(
                                            decision.features[0]))):
            return decision
        self._dispatch(sreq, decision.pair)
        self.inflight[sreq.request_id] = _Flight(
            sreq=sreq, pair=decision.pair, iters=iters,
            depart_tick=self.ticks, category=cat,
            est_cost=decision.est_cost, attempt=attempt,
            timeout_ticks=self._timeout_ticks(cat),
            est_ttft=decision.est_ttft, est_tpot=decision.est_tpot,
            complexity=float(decision.features[0]))
        return decision

    # -- public ------------------------------------------------------------------
    def submit(self, sreq: ServeRequest):
        # the span opens once here; reroutes/hedges reuse the open span
        self.tracer.begin(sreq.request_id, self.ticks)
        rcfg = self.resilience
        if rcfg is not None:
            # graceful load shedding, by SLO class: above shed_threshold the
            # cluster stops admitting batch-class work; above the (higher)
            # interactive threshold it sheds everything. An immediate cheap
            # rejection beats queueing work that will blow its deadline and
            # steal slots from requests that could still meet theirs.
            util = self.queue_len / self._capacity
            if (util >= rcfg.shed_interactive_threshold
                    or (util >= rcfg.shed_threshold
                        and sreq.slo_class == "batch")):
                self._sheds += 1
                self.tracer.event(sreq.request_id, "shed", self.ticks)
                self.tracer.end(sreq.request_id, self.ticks, "shed")
                self.done[sreq.request_id] = {"status": "shed"}
                return
        self._route_dispatch(sreq)

    def fail_node(self, node: int):
        """Crash a node: mask it and re-route its in-flight requests. The
        dead copy is cancelled from its engine (no zombie completion after
        recovery), its dispatch accounting closed as a failure, and the
        node's KV caches flushed — a restarted node holds no prefixes, so
        neither may the monitor's residency view nor its engines' pools."""
        self._down_nodes.add(node)
        self.monitor.mark_down(node)
        self.monitor.drop_prefixes(node)
        pair_node = self.router.arrays.pair_node
        # abort KV handoffs touching the dead node. Source died (covers both
        # "prefill complete but pre-transfer" and mid-transfer): the payload
        # pins go down with the node's pools below, close the prefill leg as
        # a failure. Destination died: the source is alive, drop its export
        # pins explicitly (orphaned blocks return to the cache baseline) and
        # close the leg as cancelled. Either way the request re-routes and
        # re-prefills from scratch on a healthy route.
        for rid, tr in list(self.transfers.items()):
            node_p = int(pair_node[tr.prefill_pair])
            node_q = int(pair_node[tr.decode_pair])
            if node_p != node and node_q != node:
                continue
            del self.transfers[rid]
            if node_p == node:
                self.monitor.on_failure(node_p)
                self.tracer.event(rid, "failure", self.ticks, node=node_p)
            else:
                self.engines[tr.prefill_pair].release_export(tr.block_ids)
                self.monitor.on_cancel(node_p)
                self.tracer.event(rid, "cancel", self.ticks, node=node_p)
            self._reroutes += 1
            self.tracer.event(rid, "reroute", self.ticks, node=node)
            self._route_dispatch(tr.sreq)
        for rid, fl in list(self.inflight.items()):
            hedge_dead = (fl.hedge_pair is not None
                          and int(pair_node[fl.hedge_pair]) == node)
            if hedge_dead:
                self.engines[fl.hedge_pair].cancel(rid)
                self.monitor.on_failure(node)
                self.tracer.event(rid, "failure", self.ticks, node=node)
                fl.hedge_pair = None
            if int(pair_node[fl.pair]) == node:
                self._reroutes += 1
                self.engines[fl.pair].cancel(rid)
                self.monitor.on_failure(node)
                self.tracer.event(rid, "failure", self.ticks, node=node)
                self.tracer.event(rid, "reroute", self.ticks, node=node)
                decision = self.router.route(fl.sreq.req)
                assert int(pair_node[decision.pair]) != node
                cat = int(decision.features[1])
                self.tracer.set_category(rid, cat)
                self.tracer.event(rid, "route-decision", self.ticks,
                                  pair=decision.pair, node=decision.node,
                                  prefill_pair=decision.prefill_pair)
                self._dispatch(fl.sreq, decision.pair)
                # keep the original depart tick: the monitor's completion
                # latency measures end-to-end ticks since first dispatch,
                # matching how `iters` keeps aging across the re-route
                self.inflight[rid] = _Flight(sreq=fl.sreq, pair=decision.pair,
                                             iters=fl.iters,
                                             hedge_pair=fl.hedge_pair,
                                             depart_tick=fl.depart_tick,
                                             category=cat,
                                             est_cost=decision.est_cost,
                                             est_ttft=decision.est_ttft,
                                             est_tpot=decision.est_tpot,
                                             complexity=float(
                                                 decision.features[0]))
        # dead copies are cancelled above, so no slot still pins a block
        for pair, eng in self.engines.items():
            if int(pair_node[pair]) == node:
                eng.flush_kv()

    def recover_node(self, node: int, now: Optional[float] = None):
        """Heartbeat the node back to life at simulated-scheduler time (or an
        explicit ``now``) — never at wall-clock ``time.monotonic()``. Explicit
        recovery is the ONE place a circuit breaker resets to closed: the
        per-tick auto-heartbeat deliberately never touches breakers, or they
        would re-close the instant they opened."""
        self._down_nodes.discard(node)
        self._fault_down.discard(node)
        self.monitor.reset_breaker(node)
        self.monitor.heartbeat(node, now=self.ticks if now is None else now)

    def step(self, chunk: int = 1):
        """One scheduling tick: every engine advances one decode iteration.

        ``chunk > 1`` advances each engine by up to ``chunk`` fused decode
        iterations via ``LLMEngine.step_n`` — engines with queued admissions
        fall back to a single iteration internally, so chunking only fuses
        where no admission is pending. Hedging/latency bookkeeping advances
        by the iterations each request's engine *actually* executed (a
        congested engine that fell back to one iteration must not age its
        requests by the whole chunk, or stragglers would hedge chunk-times
        early exactly where the cluster is already loaded); the scheduler
        clock stays one tick per call."""
        self.ticks += 1
        pair_node = self.router.arrays.pair_node
        # fault schedule + monitor clock first: crash/recover transitions,
        # heartbeats (minus schedule-lost ones), breaker cooldowns, and the
        # straggler slow-credit mask all apply to THIS tick's work below
        self._fault_tick()
        # deliver due KV handoffs: drop the source's export pins, land the
        # payload in the decode engine's pool (a full pool degrades to a
        # plain re-prefill — outputs stay byte-identical either way) and
        # admit the request on the decode pair, which now matches the
        # imported prefix
        for rid, tr in list(self.transfers.items()):
            if self.ticks < tr.eta:
                continue
            del self.transfers[rid]
            node_p = int(pair_node[tr.prefill_pair])
            self.engines[tr.prefill_pair].release_export(tr.block_ids)
            lat = float(self.ticks - tr.depart_tick)
            self.monitor.on_complete(node_p, latency=lat)
            self.metrics.observe("transfer", lat, node=node_p,
                                 category=tr.category)
            if self.tracer.enabled:
                self.tracer.phase(rid, "kv-transfer", tr.depart_tick, lat,
                                  node_p)
                self.tracer.event(rid, "complete", self.ticks, node=node_p)
            try:
                self.engines[tr.decode_pair].import_kv(
                    tr.tokens[:tr.n_cov], tr.payload)
                self._dispatch(tr.sreq, tr.decode_pair)
            except Exception:
                # delivery blew up mid-import: the decode pool may hold a
                # partial landing, so crash the node (flushes its pools back
                # to the refcount baseline, reroutes its flights) and send
                # this request back through routing with a full re-prefill
                node_q = int(pair_node[tr.decode_pair])
                self.monitor.on_dispatch(node_q)
                self.monitor.on_failure(node_q)
                self.tracer.event(rid, "failure", self.ticks, node=node_q)
                if node_q not in self._down_nodes:
                    self.fail_node(node_q)
                self._reroutes += 1
                self.tracer.event(rid, "reroute", self.ticks, node=node_q)
                self._route_dispatch(tr.sreq)
                continue
            self.inflight[rid] = _Flight(
                sreq=tr.sreq, pair=tr.decode_pair, depart_tick=self.ticks,
                category=tr.category, est_cost=tr.est_cost,
                timeout_ticks=self._timeout_ticks(tr.category),
                est_ttft=tr.est_ttft, est_tpot=tr.est_tpot,
                complexity=tr.complexity, prefill_node=node_p)
        # drain due retries (transient bounces and timed-out requests) —
        # after fault transitions so they route against this tick's masks
        for rid in [r for r, (due, _, _) in self._retry_queue.items()
                    if self.ticks >= due]:
            _, sreq, attempt = self._retry_queue.pop(rid)
            self.tracer.event(rid, "retry", self.ticks, attempt=attempt)
            self._route_dispatch(sreq, attempt=attempt)
        # phase A — fleet data plane: one stacked decode dispatch per cohort.
        # Members mid-admission (queued work at chunk > 1), empty, on a
        # crashed node, or on a straggler without slow-credit this tick are
        # masked out and fall back to the per-engine path in phase B;
        # everyone else advances device-side here, and the host bookkeeping
        # for their chunks runs in phase B in global pair order, so
        # monitor/hedge accounting is ordered exactly as per-engine mode.
        # Liveness (_down_nodes), not monitor.healthy_mask(), gates engine
        # progress: a breaker-open or telemetry-dark node is hidden from
        # ROUTING but its engines keep executing — only a crash stops them.
        chunk_work: Dict[int, object] = {}
        for ci, cohort in enumerate(self._cohorts):
            pairs = self._cohort_pairs[ci]
            eligible = [m for m, p in enumerate(pairs)
                        if int(pair_node[p]) not in self._down_nodes
                        and self._advance[int(pair_node[p])]]
            if not eligible:
                continue
            res = cohort.dispatch(chunk, eligible)
            if not res.work:
                continue
            # fleet counters straight off the stacked retirement mask
            self.monitor.record_fleet(self._cohort_nodes[ci],
                                      res.emitted, res.retired)
            self._cohort_part.add(ci, res.participants)
            for m, w in res.work.items():
                chunk_work[pairs[m]] = w
        # phase B — host control plane, in pair order
        advanced: Dict[int, int] = {}
        for pair, eng in self.engines.items():
            node = int(pair_node[pair])
            if node in self._down_nodes:
                continue  # crashed node makes no progress
            if not self._advance[node]:
                continue  # straggler: no slow-credit, no iteration this tick
            steps_before = eng._steps
            try:
                if pair in chunk_work:
                    retired = eng._commit_chunk(chunk_work[pair])
                else:
                    retired = eng.step_n(chunk) if chunk > 1 else eng.step()
            except Exception:
                # exception safety: an error mid-commit must not leak export
                # pins or cohort write-backs. Treat it as a node crash —
                # fail_node cancels this node's flights, re-routes them, and
                # flushes its pools back to the refcount baseline; later
                # pairs on the node are skipped via _down_nodes above.
                self.fail_node(node)
                continue
            advanced[pair] = eng._steps - steps_before
            for rid in retired:
                if rid in self.inflight:
                    fl = self.inflight.pop(rid)
                    res = eng.results[rid]
                    self.done[rid] = res
                    # completion latency in scheduler ticks — the same unit
                    # KV-handoff deliveries record — not decode iterations,
                    # which diverge by a factor of `chunk` when chunking
                    lat = float(max(self.ticks - fl.depart_tick, 1))
                    self.monitor.on_complete(node, latency=lat)
                    # QoE metrics come from the engine's step clock (decode
                    # iterations); the span phase stays in scheduler ticks
                    # so phase durations match monitor latencies exactly
                    m = self.metrics
                    m.observe("ttft", float(res["ttft_steps"]), node=node,
                              category=fl.category)
                    m.observe("tpot", float(res["tpot_steps"]), node=node,
                              category=fl.category)
                    m.observe("queue_wait", float(res["ttft_steps"]),
                              node=node, category=fl.category)
                    m.observe("cache_hit_frac", float(res["cached_frac"]),
                              node=node, category=fl.category)
                    m.observe("spend", float(fl.est_cost), node=node,
                              category=fl.category)
                    if (self.monitor.estimator is not None
                            and (fl.est_ttft > 0.0 or fl.est_tpot > 0.0)):
                        # close the online-learning loop: realized engine
                        # steps vs the estimates the decision acted on (the
                        # multiplicative residual absorbs the model-seconds
                        # -> engine-steps unit scale); prefill residual on
                        # the prefill-leg node of disaggregated routes
                        self.monitor.feed_estimator(
                            fl.category,
                            fl.prefill_node if fl.prefill_node >= 0
                            else node,
                            node, fl.sreq.req.prompt_tokens, fl.complexity,
                            OnlineEstimator.ratio(
                                fl.est_ttft, float(res["ttft_steps"])),
                            OnlineEstimator.ratio(
                                fl.est_tpot, float(res["tpot_steps"])))
                    if self.tracer.enabled:
                        self.tracer.phase(rid, "serve", fl.depart_tick, lat,
                                          node)
                        self.tracer.event(rid, "complete", self.ticks,
                                          node=node)
                    if fl.hedge_pair is not None:
                        # first completion wins: cancel the losing copy and
                        # close its dispatch accounting, or `outstanding`
                        # counts inflate forever and poison every later
                        # queue-based routing decision
                        loser = fl.hedge_pair if pair == fl.pair else fl.pair
                        self.engines[loser].cancel(rid)
                        # exactly one dispatch was charged to the loser node;
                        # close it even if the copy already drained
                        self.monitor.on_cancel(int(pair_node[loser]))
                        self.tracer.event(rid, "cancel", self.ticks,
                                          node=int(pair_node[loser]))
                    self.tracer.end(rid, self.ticks, "completed")
        # straggler hedging + deadline timeouts: age each request by its own
        # engine's progress (min 1 keeps the chunk=1 semantics for idle,
        # crashed, or credit-starved engines — wall-tick aging is exactly
        # what lets hedges and timeouts fire against a straggler)
        rcfg = self.resilience
        for rid, fl in list(self.inflight.items()):
            fl.iters += max(advanced.get(fl.pair, 0), 1)
            if (rcfg is not None and fl.iters > fl.timeout_ticks
                    and fl.attempt < rcfg.max_retries
                    and self._retry_budget_ok()):
                # deadline blown: cancel every copy (hedge included), close
                # their dispatch accounting, and re-queue with backoff. When
                # retries or the global budget are exhausted the request
                # instead keeps running — degraded service beats a drop.
                self._timeouts += 1
                self.tracer.event(rid, "timeout", self.ticks,
                                  node=int(pair_node[fl.pair]))
                copies = [fl.pair] + ([fl.hedge_pair]
                                      if fl.hedge_pair is not None else [])
                for p in copies:
                    self.engines[p].cancel(rid)
                    self.monitor.on_cancel(int(pair_node[p]))
                    self.tracer.event(rid, "cancel", self.ticks,
                                      node=int(pair_node[p]))
                del self.inflight[rid]
                self._schedule_retry(fl.sreq, fl.attempt)
                continue
            if fl.iters > self.hedge_after and fl.hedge_pair is None:
                backup = self.router.backup_pair(fl.pair)
                if backup is not None:
                    fl.hedge_pair = backup
                    self._hedges += 1
                    self.tracer.event(
                        rid, "hedge", self.ticks,
                        node=int(pair_node[backup]), pair=backup)
                    self._dispatch(fl.sreq, backup)

    def run(self, max_ticks: int = 2000, chunk: int = 1) -> Dict[int, dict]:
        t = 0
        while self.inflight or self.transfers or self._retry_queue:
            self.step(chunk=chunk)
            t += 1
            if t > max_ticks:
                raise RuntimeError(
                    f"requests stuck: {list(self.inflight)[:5]}")
        return self.done

    # -- fleet-counter aggregation (no per-engine Python loop in fleet mode) --
    @property
    def _loose_engines(self) -> List[LLMEngine]:
        """Engines outside every cohort (fleet off, or non-vectorizable)."""
        return [e for p, e in self.engines.items()
                if p not in self._pair_cohort]

    @property
    def active_count(self) -> int:
        """Occupied decode slots across the cluster — one vectorized sum per
        cohort (members sync their numpy counter slot on every slot/queue
        mutation) plus the loose stragglers."""
        n = sum(int(c.counters.active.sum()) for c in self._cohorts)
        return n + sum(e.active_count for e in self._loose_engines)

    @property
    def queue_len(self) -> int:
        """Active + queued requests across the cluster (engine semantics)."""
        n = sum(int(c.counters.active.sum() + c.counters.queued.sum())
                for c in self._cohorts)
        return n + sum(e.queue_len for e in self._loose_engines)

    @property
    def decode_dispatches(self) -> int:
        """Total decode dispatches: one per cohort chunk plus one per
        per-engine (fallback or loose) step — the O(#cohorts) vs
        O(#engines) evidence."""
        return (sum(c.counters.dispatches for c in self._cohorts)
                + sum(e.decode_dispatches for e in self.engines.values()))

    def stats(self) -> dict:
        cohorts = [{"pairs": list(pairs), "size": len(pairs),
                    "dispatches": c.counters.dispatches,
                    "emitted": int(c.counters.emitted.sum()),
                    "retired": int(c.counters.retired.sum())}
                   for c, pairs in zip(self._cohorts, self._cohort_pairs)]
        return {"completed": len(self.done), "hedges": self._hedges,
                "reroutes": self._reroutes, "handoffs": self._handoffs,
                "sheds": self._sheds, "retries": self._retries_spent,
                "timeouts": self._timeouts,
                "transient_faults": self._transients,
                "breakers": self.monitor.breaker_states(),
                "breaker_opens": [int(x)
                                  for x in self.monitor.breaker_opens],
                "transfers_inflight": len(self.transfers),
                "cancelled": sum(s.total_cancelled
                                 for s in self.monitor.stats.values()),
                "queue_lengths": self.monitor.queue_lengths(),
                "active": self.active_count,
                "queued": self.queue_len,
                "decode_dispatches": self.decode_dispatches,
                "cohorts": cohorts,
                "fleet": self.monitor.fleet_totals(),
                "percentiles": self.metrics.summary(
                    names=("latency", "ttft", "tpot", "queue_wait",
                           "transfer", "cache_hit_frac", "spend"))}
