"""Runtime request router (paper §IV-B.6, "Routing Policy Execution").

Executes a policy π* selected from the NSGA-II Pareto set. The hot path is
``route()``: feature lookup + one registered policy decision, in numpy on
the host. Beyond the paper (its §VI future work), the router is
fault-aware:

* **failover** — unhealthy nodes are masked from the candidate set; if the
  chosen node is down the request falls back to the cloud pair, or any
  healthy pair as last resort;
* **backup** — a caller may ask for a *backup* pair to duplicate a
  straggling request onto (different node than the primary);
* **re-optimization** — the rolling-horizon control loop implementing the
  paper's "small-scale NSGA-II re-optimization triggered periodically":
  ``record`` appends every served request + realized objectives to a
  bounded history; ``should_reoptimize`` fires when the monitor's fast/slow
  EWMA latency gap signals workload drift; ``maybe_reoptimize`` rebuilds a
  trace from the recorded window (open-loop when arrival timestamps were
  recorded, with the recorded SLO deadlines when present), pads it to a
  power-of-two bucket, re-runs a small NSGA-II over it **warm-started** from
  the previous run's population archive on the router's device (CUDA unless
  the caller asks for the CPU; survival through the dominance kernel), and
  installs the re-selected policy parameters.

The decision rule is pluggable: ``mode=`` names any runtime-capable policy
of the registry (``core.policies.runtime_policies()``: "threshold", "slo",
"affinity", "p2c-hedge", "budget", "bandit", "resilient", "disagg"). The
router consults the policy's declared ``requires`` set to decide which
inputs to assemble per request (per-pair phase/cost estimates, deadlines,
the monitor's prefix-cache hit fractions, KV-transfer bytes), builds one
``PolicyInputs`` bundle, and calls ``policy.decide_py``; per-policy state
(the budget ledger) is threaded through ``update_py``. A route-valued
policy (``disagg``) picks a (prefill, decode) route, failed over to a route
with both endpoints healthy when one is down. With ``learned=True`` the
monitor's :class:`~repro_torch.learn.OnlineEstimator` corrects the estimate
rows, and ``record(ttft=, tpot=)`` feeds it. The re-fit derives its genome
encoding from the same policy object (``NSGA2Config.from_policy``) and
evaluates it under the same models (prefix cache on session windows, the
route table, the estimators).

The port of ``repro.core.router``; the audit log comes with ROADMAP.md
Queue 1 item 11, and passing ``audit=`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import Device, resolve
from ..cluster.monitor import ClusterMonitor
from ..cluster.spec import ClusterArrays, ClusterSpec
from ..learn import LearnConfig, OnlineEstimator
from ..learn import estimators as learn_est
from ..workload.classifier import classify
from ..workload.datasets import Request
from ..workload.features import complexity_score
from ..workload.slo import DEFAULT_SLO_TABLE, slo_arrays
from .fitness import DEAD_QUEUE, DEAD_UP, request_pair_estimates
from .policies import (PolicyInputs, get_policy, list_policies,
                       runtime_policies)


@dataclasses.dataclass
class RouteDecision:
    pair: int
    node: int
    model: int
    go_edge: bool
    features: Tuple[float, int, float]   # (c_i, t_i, p_t)
    backup_pair: Optional[int] = None
    # disaggregated serving (route-valued policies): the prefill leg's pair.
    # None for ordinary pair decisions; equal to ``pair`` on colocated
    # routes. ``pair`` is always the decode (billing/retirement) pair.
    prefill_pair: Optional[int] = None
    # modelled $ of the chosen pair (0.0 when the policy never requested
    # estimate rows)
    est_cost: float = 0.0
    # the (possibly learned-corrected) estimates the decision acted on —
    # fed back through ``record(ttft=, tpot=)`` as the expected side of the
    # online estimator's residual targets (zero without estimate rows)
    est_ttft: float = 0.0
    est_tpot: float = 0.0
    est_quality: float = 0.0


@dataclasses.dataclass
class Observation:
    """One served request in the router's rolling history window."""

    req: Request
    pair: int
    features: Tuple[float, int, float]
    quality: float
    cost: float
    rt: float
    now: Optional[float] = None            # arrival timestamp (open loop)
    ttft_deadline: Optional[float] = None  # QoE contract, if any
    tpot_deadline: Optional[float] = None


class RequestRouter:
    def __init__(self, cluster: ClusterSpec, thresholds=None,
                 monitor: Optional[ClusterMonitor] = None,
                 mode: str = "threshold",
                 slo_params: Optional[Sequence[float]] = None,
                 slo_table=DEFAULT_SLO_TABLE,
                 cache_block: int = 16,
                 params: Optional[Sequence[float]] = None,
                 audit=None, learned: bool = False,
                 learner: LearnConfig = LearnConfig(),
                 device: Device = None):
        if audit is not None:
            raise NotImplementedError(
                "the audit log is not ported yet: ROADMAP.md Queue 1 item 11 "
                "brings it")
        self.policy = get_policy(mode)     # ValueError lists registry names
        if self.policy.genome_spec.per_request:
            raise ValueError(
                f"policy {self.policy.name!r} has a per-request genome and "
                f"cannot drive the runtime router; runtime-capable policies: "
                f"{', '.join(runtime_policies())}")
        # the re-fit's device; route() runs in numpy on the host
        self.device = resolve(device)
        self.cluster = cluster
        # numpy view of the pair table, built once: the per-request hot
        # path pays no device-to-host transfers
        self.arrays = ClusterArrays(**cluster.arrays_numpy())
        # per-policy genome store, seeded from every registered policy's
        # GenomeSpec defaults; explicit ctor args override their slot
        self._params: Dict[str, np.ndarray] = {}
        for name in list_policies():
            spec = get_policy(name).genome_spec
            if spec.defaults is not None:
                self._params[name] = np.asarray(spec.defaults, np.float32)
        if thresholds is not None:
            self._params["threshold"] = np.asarray(thresholds, np.float32)
        if slo_params is not None:
            self._params["slo"] = np.asarray(slo_params, np.float32)
        if params is not None:
            self._params[self.policy.name] = np.asarray(params, np.float32)
        self.cache_block = cache_block
        self._slo_ttft, self._slo_tpot = slo_arrays(slo_table)
        self.monitor = monitor or ClusterMonitor(len(cluster.nodes))
        self._rng = np.random.default_rng(0)
        # online learned estimators (repro_torch.learn): corrections ride on
        # the monitor, so a completion path can feed observations without
        # holding a router reference
        self.learned = learned
        self.learner = learner
        if learned and self.monitor.estimator is None:
            self.monitor.estimator = OnlineEstimator(
                learner, len(cluster.nodes), node_conc=self.arrays.node_conc)
        self._pair_node = self.arrays.pair_node
        self._pair_is_edge = self.arrays.pair_is_edge
        self._n_pairs = len(self._pair_node)
        self._pstate = self.policy.init_state()  # per-policy runtime state
        self._history: list = []        # Observation rolling window
        self._archive = None            # (P, D) genomes from the last re-opt
        self._n_recorded = 0            # monotone (history list is trimmed)
        self._last_reopt_at = 0         # _n_recorded at the last re-fit
        self._n_routed = 0              # decision counter (PolicyInputs.index)

    # -- params views -----------------------------------------------------------
    @property
    def mode(self) -> str:
        return self.policy.name

    @property
    def params(self) -> np.ndarray:
        """Active policy's genome."""
        return self._params[self.policy.name]

    @params.setter
    def params(self, value) -> None:
        self._params[self.policy.name] = np.asarray(value, np.float32)

    @property
    def thresholds(self) -> np.ndarray:
        return self._params["threshold"]

    @thresholds.setter
    def thresholds(self, value) -> None:
        self._params["threshold"] = np.asarray(value, np.float32)

    @property
    def slo_params(self) -> np.ndarray:
        return self._params["slo"]

    @slo_params.setter
    def slo_params(self, value) -> None:
        self._params["slo"] = np.asarray(value, np.float32)

    # -- hot path -------------------------------------------------------------
    def route(self, req: Request, want_backup: bool = False,
              ttft_deadline: Optional[float] = None,
              tpot_deadline: Optional[float] = None,
              now: Optional[float] = None) -> RouteDecision:
        """Route one request through the active policy.

        Explicit per-request deadlines override the per-category SLO table
        defaults (consumed by policies declaring the "deadlines"
        requirement). ``now`` is the decision timestamp for time-windowed
        policies (the budget ledger); it defaults to the router's request
        counter (pseudo-seconds: one window = WINDOW_S requests). Callers
        that pass ``now=`` to :meth:`record` must pass the same clock here,
        or the re-fit tunes the window budget on another time base."""
        pol = self.policy
        pred_cat, conf = classify(req, self._rng)
        c_i = complexity_score(req, pred_cat)
        queue = self.monitor.queue_lengths()
        healthy = self.monitor.healthy_mask()

        # mask unhealthy nodes by making their queues look infinite
        masked_queue = np.asarray(
            [q if healthy[j] else DEAD_QUEUE for j, q in enumerate(queue)],
            np.int64)

        zeros = np.zeros(self._n_pairs, np.float32)
        up = prefill = tpot = cost = prompt_cost = zeros
        if "estimates" in pol.requires:
            est = request_pair_estimates(req.prompt_tokens,
                                         req.resp_tokens_mean,
                                         req.query_bytes, self.arrays)
            # unhealthy nodes: push their pairs out of feasibility
            dead = ~np.asarray(healthy)[self._pair_node]
            up = np.where(dead, np.float32(DEAD_UP), est["up"])
            prefill, tpot = est["prefill"], est["tpot"]
            cost, prompt_cost = est["cost"], est["prompt_cost"]
        # static expected-quality prior: the build_tables q_mean formula with
        # the observable complexity score standing in for latent difficulty
        quality_row = np.clip(
            np.asarray(self.arrays.pair_base_quality,
                       np.float32)[:, req.task_id]
            + np.asarray(self.arrays.pair_diff_slope, np.float32)
            * (np.float32(0.5) - np.float32(c_i)),
            np.float32(0.0), np.float32(1.0)).astype(np.float32)
        unc_row = zeros
        if self.learned and self.monitor.estimator is not None:
            d_p, d_t, d_q, unc_n = self.monitor.estimator.predict(
                pred_cat, req.prompt_tokens, c_i, masked_queue,
                self.arrays.node_conc)
            prefill, tpot, quality_row, unc_row = learn_est.corrected_rows(
                np, np.asarray(prefill, np.float32),
                np.asarray(tpot, np.float32), quality_row, d_p, d_t, d_q,
                unc_n, self._pair_node)
        ttft_dl = (ttft_deadline if ttft_deadline is not None
                   else float(self._slo_ttft[pred_cat]))
        tpot_dl = (tpot_deadline if tpot_deadline is not None
                   else float(self._slo_tpot[pred_cat]))
        hit = zeros
        if "cache" in pol.requires:
            hit_node = self.monitor.hit_fractions(
                req.session_id, req.sys_id, float(req.prompt_tokens),
                float(req.sys_tokens), block=self.cache_block)
            hit = np.asarray(hit_node, np.float32)[self._pair_node]
        kv_bytes = zeros
        if "transfer" in pol.requires:
            blk = float(self.cache_block)
            kv_blk = np.float32(np.floor(
                np.float32(req.prompt_tokens) / np.float32(blk)) * blk)
            kv_bytes = (kv_blk * np.asarray(
                self.arrays.pair_kv_bytes_per_token,
                np.float32)).astype(np.float32)

        inp = PolicyInputs(
            index=np.int32(self._n_routed),
            now=np.float32(self._n_routed if now is None else now),
            complexity=np.float32(c_i), pred_category=np.int32(pred_cat),
            pred_conf=np.float32(conf), ttft_deadline=np.float32(ttft_dl),
            tpot_deadline=np.float32(tpot_dl),
            prompt_tokens=np.float32(req.prompt_tokens),
            up=up, prefill=prefill, tpot=tpot, cost=cost,
            prompt_cost=prompt_cost, hit_frac=hit, queue_len=masked_queue,
            kv_bytes=kv_bytes, quality=quality_row, unc=unc_row)
        decision = int(pol.decide_py(self.params, inp, self.arrays,
                                     self._pstate))

        prefill_pair = None
        if pol.decides == "route":
            # route-valued decision: resolve the (prefill, decode) legs;
            # ``pair`` is the decode pair from here on
            rp, rq = self.arrays.route_prefill, self.arrays.route_decode
            prefill_pair, pair = int(rp[decision]), int(rq[decision])
            node_p = int(self._pair_node[prefill_pair])
            node = int(self._pair_node[pair])
            if not (healthy[node_p] and healthy[node]):
                # failover: re-pick among routes with both endpoints healthy,
                # preferring colocated ones (no handoff exposure while the
                # cluster is degraded), then least-loaded decode node
                cands = [r for r in range(len(rp))
                         if healthy[self._pair_node[rp[r]]]
                         and healthy[self._pair_node[rq[r]]]]
                if not cands:
                    raise RuntimeError("no healthy nodes in cluster")
                colo = [r for r in cands if rp[r] == rq[r]]
                decision = min(colo or cands,
                               key=lambda r: queue[self._pair_node[rq[r]]])
                prefill_pair, pair = int(rp[decision]), int(rq[decision])
                node = int(self._pair_node[pair])
        else:
            pair = decision
            node = int(self._pair_node[pair])

            # failover: if the policy returned a pair on a dead node (e.g.
            # the cloud fallback itself is down), pick any healthy pair
            if not healthy[node]:
                alive = [p for p in range(self._n_pairs)
                         if healthy[self._pair_node[p]]]
                if not alive:
                    raise RuntimeError("no healthy nodes in cluster")
                # prefer healthy cloud, then least-loaded healthy edge
                cloud_alive = [p for p in alive if not self._pair_is_edge[p]]
                pair = (cloud_alive[0] if cloud_alive else
                        min(alive, key=lambda p: queue[self._pair_node[p]]))
                node = int(self._pair_node[pair])

        # policy state advances on the pair actually dispatched (post
        # failover), and only for requests dispatched at all
        self._pstate = pol.update_py(self.params, self._pstate, inp, pair,
                                     float(cost[pair]))
        self._n_routed += 1

        backup = self.backup_pair(pair) if want_backup else None
        # the estimates this decision acted on (TTFT on the prefill leg,
        # TPOT on the decode pair): the expected side of record()'s targets
        pp = pair if prefill_pair is None else prefill_pair
        return RouteDecision(
            pair=int(pair), node=node,
            model=int(self.arrays.pair_model[pair]),
            go_edge=bool(self._pair_is_edge[pair]),
            features=(c_i, pred_cat, conf), backup_pair=backup,
            prefill_pair=prefill_pair, est_cost=float(cost[pair]),
            est_ttft=float(up[pp] + prefill[pp]),
            est_tpot=float(tpot[pair]),
            est_quality=float(quality_row[pair]))

    def backup_pair(self, primary: int) -> Optional[int]:
        """A healthy pair on a *different* node, for hedged duplicates."""
        healthy = self.monitor.healthy_mask()
        pnode = int(self._pair_node[primary])
        cands = [p for p in range(self._n_pairs)
                 if int(self._pair_node[p]) != pnode
                 and healthy[self._pair_node[p]]]
        if not cands:
            return None
        # cheapest viable alternative: cloud if primary was edge, else the
        # least-loaded edge instruct pair
        queue = self.monitor.queue_lengths()
        return min(cands, key=lambda p: (queue[self._pair_node[p]],
                                         self._pair_is_edge[p]))

    # -- feedback & re-optimization --------------------------------------------
    def record(self, req: Request, decision: RouteDecision, quality: float,
               cost: float, rt: float, now: Optional[float] = None,
               ttft_deadline: Optional[float] = None,
               tpot_deadline: Optional[float] = None,
               ttft: Optional[float] = None,
               tpot: Optional[float] = None) -> None:
        """Append one served request + realized objectives to the rolling
        history window ``maybe_reoptimize`` re-fits against. ``now`` is the
        request's arrival timestamp (enables open-loop re-fitting); the
        deadline pair is its QoE contract if it carried one. Realized
        ``ttft``/``tpot`` (the caller's clock units — the ratio residual
        absorbs the scale) close the learning loop: each becomes a
        realized-vs-estimated residual against the decision's own estimates
        and goes to the monitor's :class:`OnlineEstimator`."""
        est_obj = self.monitor.estimator
        if est_obj is not None and (ttft is not None or tpot is not None):
            y_p = (OnlineEstimator.ratio(decision.est_ttft, ttft)
                   if ttft is not None else 0.0)
            y_t = (OnlineEstimator.ratio(decision.est_tpot, tpot)
                   if tpot is not None else 0.0)
            y_q = (float(np.float32(quality)
                         - np.float32(decision.est_quality))
                   if decision.est_quality > 0.0 else 0.0)
            node_p = (decision.node if decision.prefill_pair is None
                      else int(self._pair_node[decision.prefill_pair]))
            self.monitor.feed_estimator(
                int(decision.features[1]), node_p, decision.node,
                req.prompt_tokens, float(decision.features[0]),
                y_p, y_t, y_q)
        self._history.append(Observation(
            req=req, pair=decision.pair, features=decision.features,
            quality=quality, cost=cost, rt=rt, now=now,
            ttft_deadline=ttft_deadline, tpot_deadline=tpot_deadline))
        self._n_recorded += 1
        if len(self._history) > 10000:
            self._history = self._history[-5000:]

    @property
    def history_size(self) -> int:
        return len(self._history)

    def should_reoptimize(self, drift_threshold: float = 0.25,
                          min_history: int = 64,
                          min_new: int = 32) -> bool:
        """Drift trigger: re-optimize when the monitor's fast EWMA latency
        has moved more than ``drift_threshold`` (relative) away from its slow
        baseline, enough history is banked to re-fit on, and at least
        ``min_new`` requests were observed since the last re-fit (cooldown —
        together with the post-re-fit drift re-baseline this makes one
        regime shift trigger one re-fit, not one per check)."""
        return (len(self._history) >= min_history
                and self._n_recorded - self._last_reopt_at >= min_new
                and self.monitor.drift_score() >= drift_threshold)

    def window_trace(self, window: int = 256, seed: int = 0):
        """The trace a re-fit scores genomes on, rebuilt from the last
        ``window`` recorded requests (None without history): open-loop at
        the recorded arrival timestamps when every observation carries one
        and they never go back; with the recorded features, and with the
        recorded deadlines when every observation carries a contract (for
        deadline policies, the per-category table's otherwise)."""
        from ..workload.trace import trace_from_requests

        obs = self._history[-window:]
        if not obs:
            return None
        arrivals = None
        if all(o.now is not None for o in obs):
            t = np.asarray([o.now for o in obs], np.float32)
            if (np.diff(t) >= 0).all():
                arrivals = t
        trace = trace_from_requests([o.req for o in obs], seed=seed,
                                    arrival_time=arrivals)
        # re-fit against the features the live router actually observed and
        # acted on, not a fresh classifier noise draw
        trace.complexity = np.asarray([o.features[0] for o in obs],
                                      np.float32)
        trace.pred_category = np.asarray([o.features[1] for o in obs],
                                         np.int32)
        trace.pred_conf = np.asarray([o.features[2] for o in obs],
                                     np.float32)
        if all(o.ttft_deadline is not None and o.tpot_deadline is not None
               for o in obs):
            trace.ttft_deadline = np.asarray(
                [o.ttft_deadline for o in obs], np.float32)
            trace.tpot_deadline = np.asarray(
                [o.tpot_deadline for o in obs], np.float32)
        elif "deadlines" in self.policy.requires:
            # deadline-aware genomes are meaningless against +inf deadlines
            # (every parameter vector is equally feasible -> degenerate flat
            # fitness): fall back to the per-category table defaults
            # route() applies
            cat = trace.pred_category
            trace.ttft_deadline = self._slo_ttft[cat].astype(np.float32)
            trace.tpot_deadline = self._slo_tpot[cat].astype(np.float32)
        return trace

    def maybe_reoptimize(self, window: int = 256, generations: int = 20,
                         pop_size: int = 32,
                         weights: Optional[Sequence[float]] = None,
                         seed: int = 0, concurrency: int = 4,
                         drift_threshold: float = 0.25,
                         min_history: int = 64,
                         force: bool = False) -> Optional[np.ndarray]:
        """Rolling-horizon re-optimization (paper §IV-B.6, made real).

        Unless ``force``, runs only when :meth:`should_reoptimize` fires.
        Re-fits a small NSGA-II against the last ``window`` *recorded*
        requests: the observed trace is rebuilt by :meth:`window_trace`
        (open-loop at the recorded arrival timestamps, closed-loop with
        ``concurrency`` clients otherwise; the 4-objective QoE fitness when
        it carries deadlines) and padded to a power-of-two bucket. The
        genome encoding comes from the active policy's registry entry. The
        search runs on
        the router's device, seeded with ``seed``, warm-started from the
        previous re-opt's survival-ordered population; then the Eq. (1)
        weighted-sum pick (uniform ``weights`` by default) replaces the live
        policy parameters. Returns them, or None if skipped.
        """
        from .fitness import EvalConfig, TraceEvaluator
        from .nsga2 import NSGA2, NSGA2Config

        if not force and not self.should_reoptimize(drift_threshold,
                                                    min_history):
            return None
        trace = self.window_trace(window, seed)
        if trace is None:
            return None
        pol = self.policy

        cfg_eval = EvalConfig(
            mode="open" if trace.has_arrivals else "queued",
            concurrency=concurrency,
            # re-fit against the cache dynamics the window actually had
            prefix_cache=(trace.has_arrivals and trace.has_sessions),
            cache_block=self.cache_block,
            # route-valued policies re-fit against the disaggregated model
            disaggregated=pol.decides == "route",
            # re-fit with the estimator loop the live router runs, so the
            # tuned genome suits corrected (not static-prior) estimate rows
            learned=self.learned, learner=self.learner)
        evaluator = TraceEvaluator(trace, self.cluster, cfg_eval,
                                   bucket="pow2", device=self.device)

        # genome encoding from the active policy's registry entry
        cfg = NSGA2Config.from_policy(pol, pop_size=pop_size,
                                      n_generations=generations)
        objectives = "qoe" if trace.has_slos else "paper"
        opt = NSGA2(evaluator.make_fitness(pol.name, objectives=objectives),
                    cfg, device=self.device)
        # warm start from the previous re-fit's survival-ordered population
        archive = self._archive
        if archive is not None and archive.shape[1] != cfg.n_genes:
            archive = None              # policy switched since the last fit
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = opt.evolve_scan(gen, generations, archive=archive)
        # archive the survival-ordered population for the next warm start
        self._archive = state.genomes.cpu().numpy()

        M = state.F_raw.shape[1]
        w = (np.full((M,), 1.0 / M, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        genome, _ = opt.select_by_weights(state, w)
        self.params = genome.cpu().numpy()
        # cooldown: re-arm the drift detector for the *next* regime shift
        self._last_reopt_at = self._n_recorded
        self.monitor.rebaseline_drift()
        return self.params
