"""Discrete-event simulator of the cloud-edge cluster: a numpy copy of
``repro.cluster.simulator`` (every mode: closed and open loop, the prefix
cache, disaggregated routes, fault injection, learned estimators), held
bit-equal to the original by ``tests/test_torch_data.py`` and
``tests/test_torch_simulator.py``. The port's changes are its imports: the
static tables come from ``core.fitness.build_tables_numpy`` (the tables the
evaluator moves to its device) and the policies from the port's registry.

This is the *oracle* counterpart of the JAX evaluator in
``repro.core.fitness``: a classic heap-based event loop with explicit client
and slot entities. The two implementations are developed independently and a
property test (tests/test_fitness_equivalence.py) asserts they agree on random
traces/policies — the standard way to de-risk a vectorized rewrite.

It also powers failure-injection experiments that the fixed-shape JAX scan
does not model: node crash/recovery events, hedged requests, and reroute-on-
failure, used by the serving scheduler tests.

With ``prefix_cache=True`` (session traces from ``workload.sessions``, open
loop) both oracles mirror the JAX evaluator's prefix-cache model: a served
prompt's whole-block prefix stays resident on its node, and a later request
of the same session (or sharing the same system prompt) on that node pays
only the uncached prefill fraction plus a discounted price for cached prompt
tokens — the equivalence property extends to this regime.

Both oracles can also make the routing decision *themselves*: pass
``policy=<registry name>, genome=...`` instead of ``assign`` and every
dispatch builds the same ``PolicyInputs`` bundle the JAX scan builds (busy
slots at arrival, per-pair cache hit fractions, deadline contract, float32
estimate rows) and calls ``RoutingPolicy.decide_py`` through the registry —
no per-policy mirroring here, so new policy modules get DES-oracle coverage
(and the JAX/DES equivalence property, tests/test_online.py) for free.
Per-policy decision state (e.g. the budget spend ledger) threads through
``RoutingPolicy.update_py`` in dispatch order, exactly like the scan carry.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.policies import PolicyInputs, get_policy
from ..faults import (FaultSchedule, link_slowdown_np, node_available_np,
                      node_slowdown_np, transient_delay_np)
from ..learn import LearnConfig
from ..learn import estimators as learn_est
from ..obs.trace import NOOP_TRACER
from ..workload.trace import Trace
from .spec import ClusterArrays, ClusterSpec


@dataclasses.dataclass
class SimResult:
    q: np.ndarray
    cost: np.ndarray
    rt: np.ndarray
    assign: np.ndarray
    wait: np.ndarray
    node_busy_time: np.ndarray
    # phase split (QoE accounting, mirrors fitness.EvalResult); optional so
    # externally-constructed pre-QoE SimResults keep working
    ttft: Optional[np.ndarray] = None   # upload + queue wait + prefill
    tpot: Optional[np.ndarray] = None   # decode seconds per output token
    hit: Optional[np.ndarray] = None    # realized cached-prefix fraction
    # KV-transfer seconds between prefill and decode (disaggregated runs;
    # exactly 0 on colocated routes)
    transfer: Optional[np.ndarray] = None
    # learned-estimator accounting (ClusterSimulator(learned=True) runs):
    # per-request decision-time estimates vs. realized values of the phase
    # times the estimators correct (full-prompt prefill seconds and decode
    # s/token, both including straggler stretch), and the final estimator
    # state — reseedable into the next window via run(learn_state=)
    est_prefill: Optional[np.ndarray] = None
    est_tpot: Optional[np.ndarray] = None
    real_prefill: Optional[np.ndarray] = None
    real_tpot: Optional[np.ndarray] = None
    learn_state: Optional[np.ndarray] = None

    def summary(self) -> Dict[str, float]:
        out = {"avg_quality": float(self.q.mean()),
               "avg_response_time": float(self.rt.mean()),
               "avg_cost": float(self.cost.mean())}
        if self.ttft is not None:
            out["avg_ttft"] = float(self.ttft.mean())
            out["avg_tpot"] = float(self.tpot.mean())
        return out

    def slo_attainment(self, ttft_deadline: np.ndarray,
                       tpot_deadline: np.ndarray) -> float:
        """Fraction of requests meeting both phase deadlines.

        Deliberately re-implements the attainment predicate rather than
        calling objectives.slo_ok: this class is the independent oracle the
        JAX path is validated against (tests/test_slo.py), so sharing the
        expression would defeat the cross-check.
        """
        assert self.ttft is not None, "result carries no phase accounting"
        ok = (self.ttft <= ttft_deadline) & (self.tpot <= tpot_deadline)
        return float(ok.mean())


class ClusterSimulator:
    """Trace execution with per-node slots: closed-loop (G clients) or
    open-loop (requests released at explicit ``arrivals`` timestamps)."""

    def __init__(self, trace: Trace, cluster: ClusterSpec, seed: int = 0,
                 prefix_cache: bool = False, cache_block: int = 16,
                 disaggregated: bool = False, faults=None,
                 learned: bool = False, learner: LearnConfig = LearnConfig()):
        if prefix_cache:
            assert trace.has_sessions and trace.has_arrivals, \
                "prefix_cache needs an open-loop session trace"
        self.trace = trace
        self.cluster = cluster
        self.prefix_cache = prefix_cache
        self.cache_block = cache_block
        self.disaggregated = disaggregated
        # online-learned estimators (repro.learn): the DES twin of the JAX
        # scan's EvalConfig(learned=True) — corrected PolicyInputs rows at
        # decision time, residual updates at dispatch, float32 op-for-op
        self.learned = learned
        self.learner = learner
        # reuse the same static tables as the JAX path so quality/cost/
        # service-time definitions are shared; only queueing is independent
        from ..core.fitness import build_tables_numpy
        tables, arrays = build_tables_numpy(trace, cluster, seed=seed)
        self.quality = np.asarray(tables["quality"])
        self.quality_mean = np.asarray(tables["quality_mean"])
        self.cost = np.asarray(tables["cost"])
        self.service = np.asarray(tables["service"])
        self.up = np.asarray(tables["up_time"])
        self.down = np.asarray(tables["down_time"])
        self.prefill = np.asarray(tables["prefill_time"])
        self.tpot_pair = np.asarray(tables["tpot"])
        self.prompt_cost = np.asarray(tables["prompt_cost"])
        # the pair table as numpy fields (the policies' decide_py reads it)
        self.np_arrays = self.arrays = ClusterArrays(**{
            f: np.asarray(arrays[f]) for f in ClusterArrays._fields})
        self.pair_node = self.np_arrays.pair_node
        self.node_conc = self.np_arrays.node_conc
        # colocated route per pair (disaggregated fault fallback)
        self._colo_route = {
            int(p): r for r, (p, q_) in enumerate(
                zip(self.np_arrays.route_prefill,
                    self.np_arrays.route_decode)) if p == q_}
        # deterministic fault injection (repro.faults): a FaultSchedule (or
        # pre-compiled FaultTables) mirrored op-for-op against the JAX
        # scan's EvalConfig(faulty=True) branches
        if isinstance(faults, FaultSchedule):
            faults = faults.compile(len(cluster.nodes))
        self.faults = faults

    # -- fault-injection mirror ----------------------------------------------
    def _fault_ctx(self, i: int, arrival: float):
        """(t_eff, avail, slow, linkf, delay) at request ``i``'s effective
        arrival — the DES twin of the scan's fault context — or None when
        no schedule is attached. Float32 arithmetic like the scan."""
        if self.faults is None:
            return None
        ft = self.faults
        delay = float(transient_delay_np(ft, i))
        t_eff = float(np.float32(arrival) + np.float32(delay))
        return (t_eff, node_available_np(ft, t_eff),
                node_slowdown_np(ft, t_eff),
                float(link_slowdown_np(ft, t_eff)), delay)

    def _fault_failover(self, decided: int, avail) -> Tuple[int, bool]:
        """The scan's deterministic failover: if the decision lands on a
        crashed node, prefer the lowest-index alive cloud pair (alive
        colocated route when disaggregated), else the lowest alive index."""
        a = self.np_arrays
        if self.disaggregated:
            rp, rq = a.route_prefill, a.route_decode
            dead = (~avail[self.pair_node[rp]]) | (~avail[self.pair_node[rq]])
            if not dead[decided]:
                return decided, False
            rank = ((rp != rq).astype(np.float32) * np.float32(1e6)
                    + np.arange(len(rp), dtype=np.float32))
        else:
            dead = ~avail[self.pair_node]
            if not dead[decided]:
                return decided, False
            rank = (a.pair_is_edge.astype(np.float32) * np.float32(1e6)
                    + np.arange(len(dead), dtype=np.float32))
        return int(np.argmin(np.where(dead, np.inf, rank))), True

    # -- prefix-cache mirror (independent of the JAX carry implementation) ----
    def _cache_state(self):
        return {} if self.prefix_cache else None

    def _cache_hit(self, state, i: int, node: int) -> float:
        """Cached fraction of request i's prompt on ``node`` (0 when the
        model is off), from the per-(node, session/system-prompt) state."""
        if state is None:
            return 0.0
        tr = self.trace
        P = float(tr.prompt_tokens[i])
        blk = self.cache_block
        g = int(tr.group_id[i])
        y = int(tr.sys_id[i]) if tr.sys_id is not None else -1
        hit = 0.0
        if g >= 0:
            hit = min(state.get((node, "sess", g), 0.0),
                      float(int(P) // blk * blk))
        if y >= 0:
            sys_tok = float(tr.sys_tokens[i])
            hit = max(hit, min(state.get((node, "sys", y), 0.0),
                               float(int(sys_tok) // blk * blk)))
        return hit / max(P, 1.0)

    def _cache_admit(self, state, i: int, node: int) -> None:
        if state is None:
            return
        tr = self.trace
        blk = self.cache_block
        g = int(tr.group_id[i])
        y = int(tr.sys_id[i]) if tr.sys_id is not None else -1
        if g >= 0:
            key = (node, "sess", g)
            state[key] = max(state.get(key, 0.0),
                             float(int(tr.prompt_tokens[i]) // blk * blk))
        if y >= 0:
            key = (node, "sys", y)
            state[key] = max(state.get(key, 0.0),
                             float(int(tr.sys_tokens[i]) // blk * blk))

    def _discounted(self, state, i: int, pair: int):
        """(hit_frac, service_eff, prefill_eff, cost_eff) for request i."""
        from ..core.policies.affinity import CACHED_TOKEN_PRICE_FACTOR
        node = int(self.pair_node[pair])
        hf = self._cache_hit(state, i, node)
        service = self.service[i, pair] - hf * self.prefill[i, pair]
        prefill = self.prefill[i, pair] * (1.0 - hf)
        cost = (self.cost[i, pair]
                - hf * (1.0 - CACHED_TOKEN_PRICE_FACTOR)
                * self.prompt_cost[i, pair])
        return hf, service, prefill, cost

    # -- registry-driven in-loop decisions -----------------------------------
    def _resolve_policy(self, policy, genome, assign):
        """Validate the (policy, genome) / assign alternative and return
        (RoutingPolicy | None, cast genome, init decision state)."""
        if policy is None:
            assert assign is not None, "need either assign or policy+genome"
            return None, None, None
        pol = get_policy(policy)        # ValueError lists registered names
        assert genome is not None, f"policy {pol.name!r} needs a genome"
        if not pol.genome_spec.per_request:
            want = "route" if self.disaggregated else "pair"
            assert pol.decides == want, \
                (f"policy {pol.name!r} decides over {pol.decides!r} indices "
                 f"but the simulator was built with "
                 f"disaggregated={self.disaggregated}")
        g = np.asarray(genome,
                       np.int32 if pol.genome_spec.discrete else np.float32)
        return pol, g, pol.init_state()

    def _policy_inputs(self, i: int, busy, cache, now: float,
                       avail=None, lstate=None) -> PolicyInputs:
        """The DES twin of the JAX scan's decision context: same float32
        table rows, busy-slot counts at arrival, whole-block cache hit
        fractions, and deadline contract (+inf without SLOs). ``avail``
        (fault injection) masks crashed nodes out of the policy's view with
        the router's sentinels (queue_len -> 1e6, up -> 1e9)."""
        from ..core.fitness import DEAD_QUEUE, DEAD_UP
        tr = self.trace
        n_nodes = len(self.cluster.nodes)
        up_row = self.up[i]
        queue = np.asarray(busy, np.int64)
        if avail is not None:
            queue = np.where(avail, queue, DEAD_QUEUE)
            up_row = np.where(avail[self.pair_node], up_row,
                              np.float32(DEAD_UP)).astype(np.float32)
        if cache is not None:
            hit_node = np.asarray(
                [self._cache_hit(cache, i, n) for n in range(n_nodes)],
                np.float32)
            hit = hit_node[self.pair_node]
        else:
            hit = np.zeros(len(self.pair_node), np.float32)
        has_slos = tr.has_slos
        if self.disaggregated:
            blk = float(self.cache_block)
            kv_blk = np.float32(np.floor(
                np.float32(tr.prompt_tokens[i]) / np.float32(blk)) * blk)
            kv_bytes = (kv_blk * np.asarray(
                self.np_arrays.pair_kv_bytes_per_token,
                np.float32)).astype(np.float32)
        else:
            kv_bytes = np.zeros(len(self.pair_node), np.float32)
        if self.learned and lstate is not None:
            # learned-estimator correction, mirroring the scan op-for-op:
            # residual posteriors override the prefill/tpot estimate rows
            # and fill the quality/unc rows (neutral state -> bitwise the
            # static rows)
            x1, x2, x3 = learn_est.features(
                np, np.float32(tr.prompt_tokens[i]),
                np.float32(tr.complexity[i]), queue,
                np.asarray(self.node_conc))
            d_p, d_t, d_q, unc_n = learn_est.predict_np(
                self.learner, lstate, n_nodes, int(tr.pred_category[i]),
                x1, x2, x3)
            prefill_row, tpot_row, quality_row, unc_row = \
                learn_est.corrected_rows(
                    np, np.asarray(self.prefill[i], np.float32),
                    np.asarray(self.tpot_pair, np.float32),
                    np.asarray(self.quality_mean[i], np.float32),
                    d_p, d_t, d_q, unc_n, np.asarray(self.pair_node))
        else:
            prefill_row = self.prefill[i]
            tpot_row = self.tpot_pair
            quality_row = self.quality_mean[i]
            unc_row = np.zeros(len(self.pair_node), np.float32)
        return PolicyInputs(
            index=np.int32(i), now=np.float32(now),
            complexity=np.float32(tr.complexity[i]),
            pred_category=np.int32(tr.pred_category[i]),
            pred_conf=np.float32(tr.pred_conf[i]),
            ttft_deadline=np.float32(tr.ttft_deadline[i] if has_slos
                                     else np.inf),
            tpot_deadline=np.float32(tr.tpot_deadline[i] if has_slos
                                     else np.inf),
            prompt_tokens=np.float32(tr.prompt_tokens[i]),
            up=up_row, prefill=prefill_row, tpot=tpot_row,
            cost=self.cost[i], prompt_cost=self.prompt_cost[i],
            hit_frac=hit, queue_len=queue,
            kv_bytes=kv_bytes, quality=quality_row, unc=unc_row)

    # -- learned-estimator feedback (shared by both oracles) ------------------
    def _learn_observe(self, lstate, i: int, inp: PolicyInputs, pair_p: int,
                       pair_q: int, node_p: int, node_q: int, slow_p: float,
                       slow_q: float) -> np.ndarray:
        """Feed the dispatched request's residual targets into the estimator
        state: the scan's update mirror (prefill residual on the prefill
        node, tpot + quality on the decode node; fault-free observations are
        exact zeros for the latency signals)."""
        x1, x2, x3 = learn_est.features(
            np, inp.prompt_tokens, inp.complexity,
            np.asarray(inp.queue_len, np.int64), np.asarray(self.node_conc))
        y_p, y_t, y_q = learn_est.observations(
            np, np.float32(self.prefill[i, pair_p]), np.float32(slow_p),
            np.float32(self.tpot_pair[pair_q]), np.float32(slow_q),
            np.float32(self.quality[i, pair_q]),
            np.float32(self.quality_mean[i, pair_q]))
        return learn_est.update_np(
            self.learner, lstate, len(self.node_conc),
            int(inp.pred_category), node_p, node_q, x1, x2, x3, y_p, y_t,
            y_q)

    def _learn_after_colo(self, lstate, i: int, inp, pair: int, node: int,
                          slow_n: float, est_p, est_t, real_p, real_t):
        """Record est-vs-realized phase times and update the state after a
        colocated dispatch (realized = full static phase × straggler)."""
        est_p[i] = float(inp.prefill[pair])
        est_t[i] = float(inp.tpot[pair])
        real_p[i] = float(self.prefill[i, pair]) * slow_n
        real_t[i] = float(self.tpot_pair[pair]) * slow_n
        return self._learn_observe(lstate, i, inp, pair, pair, node, node,
                                   slow_n, slow_n)

    def _learn_after_disagg(self, lstate, i: int, inp, row, fc, est_p,
                            est_t, real_p, real_t):
        """Disaggregated twin of :meth:`_learn_after_colo`: prefill leg
        attributed to the prefill node, tpot/quality to the decode node."""
        pp, qd = row["pp"], row["pair"]
        lp, lq = row["lp"], row["lq"]
        slow_p = 1.0 if fc is None else float(fc[2][lp])
        slow_q = 1.0 if fc is None else float(fc[2][lq])
        est_p[i] = float(inp.prefill[pp])
        est_t[i] = float(inp.tpot[qd])
        real_p[i] = float(self.prefill[i, pp]) * slow_p
        real_t[i] = float(self.tpot_pair[qd]) * slow_q
        return self._learn_observe(lstate, i, inp, pp, qd, lp, lq, slow_p,
                                   slow_q)

    def _learn_init(self, pol, learn_state):
        """Initial estimator state for a run (None when learning is off)."""
        if not self.learned:
            return None
        assert pol is not None, \
            "learned=True needs in-loop policy= decisions (not assign=)"
        if learn_state is not None:
            return np.asarray(learn_state, np.float32).copy()
        return learn_est.init_state(self.learner, len(self.node_conc))

    # -- observability emission (shared by both oracles, so the span and
    # audit streams are identical by construction) ----------------------------
    def _trace_issue(self, tracer, audit, i: int, now: float, pol, g, inp,
                     raw: int, decided: int,
                     failover: Optional[str] = None) -> None:
        """Open request i's span and log its routing decision. ``decided``
        is a pair index (colocated mode) or a route index (disaggregated);
        ``raw`` is the policy output before any down-node failover."""
        if tracer.enabled:
            tracer.begin(i, now,
                         category=int(self.trace.pred_category[i]))
            tracer.event(i, "route-decision", now, decision=int(decided),
                         raw=int(raw), failover=failover)
        if audit is not None and pol is not None:
            if self.disaggregated:
                a = self.np_arrays
                pair = int(a.route_decode[decided])
                prefill_pair = int(a.route_prefill[decided])
            else:
                pair = int(decided)
                prefill_pair = None
            audit.record(
                i, now, pol.name, pol.decides, g, raw, pair,
                int(self.pair_node[pair]), prefill_pair=prefill_pair,
                failover=failover, queue=inp.queue_len,
                category=int(inp.pred_category), up=inp.up,
                prefill=inp.prefill, tpot=inp.tpot, cost=inp.cost,
                hit=inp.hit_frac, est_cost=float(inp.cost[pair]))

    def _trace_colo(self, tracer, i: int, arrival: float, pair: int,
                    node: int, wait_i: float, prefill_i: float,
                    decode_i: float, completion: float) -> None:
        """Phase timeline of a colocated execution; the five phase
        durations sum to ``completion - arrival`` (span conservation)."""
        if not tracer.enabled:
            return
        up_i = float(self.up[i, pair])
        down_i = float(self.down[i, pair])
        ready = arrival + up_i
        start = ready + wait_i
        tracer.event(i, "dispatch", arrival, node=node, pair=int(pair))
        tracer.phase(i, "upload", arrival, up_i, node)
        tracer.phase(i, "queue-wait", ready, wait_i, node)
        tracer.phase(i, "prefill", start, prefill_i, node)
        tracer.phase(i, "decode", start + prefill_i, decode_i, node)
        tracer.phase(i, "download", start + prefill_i + decode_i, down_i,
                     node)
        tracer.event(i, "complete", completion, node=node)
        tracer.end(i, completion, "completed")

    def _record_metrics(self, metrics, res: "SimResult") -> None:
        """Vectorized post-run ingest of a SimResult into the registry
        (per-(node, category) labels from the realized assignment)."""
        if metrics is None:
            return
        if self.disaggregated:
            nodes = self.pair_node[
                np.asarray(self.np_arrays.route_decode)[res.assign]]
        else:
            nodes = self.pair_node[res.assign]
        cats = np.asarray(self.trace.pred_category)
        metrics.observe_by("ttft", res.ttft, nodes, cats)
        metrics.observe_by("tpot", res.tpot, nodes, cats)
        metrics.observe_by("queue_wait", res.wait, nodes, cats)
        metrics.observe_by("transfer", res.transfer, nodes, cats)
        metrics.observe_by("cache_hit_frac", res.hit, nodes, cats)
        metrics.observe_by("spend", res.cost, nodes, cats)
        metrics.observe_by("latency", res.rt, nodes, cats)

    # -- disaggregated execution (shared by both oracles) --------------------
    def _disagg_exec(self, cache, i: int, route: int, slots, arrival: float,
                     tracer=NOOP_TRACER, fc=None):
        """Greedy-at-issue execution of one request over route ``route``:
        prefill leg, KV transfer (0 on colocated routes), decode leg.
        Mirrors the JAX scan's disaggregated arithmetic op-for-op; mutates
        ``slots`` and the cache state, returns the accounting row."""
        from ..core.policies.affinity import CACHED_TOKEN_PRICE_FACTOR
        a = self.np_arrays
        p = int(a.route_prefill[route])
        qd = int(a.route_decode[route])
        node_p = int(self.pair_node[p])
        node_q = int(self.pair_node[qd])
        colo = p == qd
        blk = float(self.cache_block)
        kv_blk = float(np.floor(float(self.trace.prompt_tokens[i]) / blk)
                       * blk)
        kv_b = kv_blk * float(a.pair_kv_bytes_per_token[p])
        hf = self._cache_hit(cache, i, node_p)
        prefill_eff = self.prefill[i, p] * (1.0 - hf)
        decode_t = self.service[i, qd] - self.prefill[i, qd]
        tt = (float(a.kv_lat[node_p, node_q])
              + kv_b * float(a.kv_inv_bw[node_p, node_q]))
        cost_i = (self.prompt_cost[i, p]
                  * (1.0 - hf * (1.0 - CACHED_TOKEN_PRICE_FACTOR))
                  + (self.cost[i, qd] - self.prompt_cost[i, qd])
                  + kv_b * float(a.kv_egress[node_p, node_q]))
        slow_q = 1.0
        if fc is not None:
            # straggler factors per leg, link flap on the transfer, transient
            # delay shifting the effective arrival (scan mirror)
            t_eff, _, slow, linkf, _ = fc
            prefill_eff = prefill_eff * float(slow[node_p])
            slow_q = float(slow[node_q])
            decode_t = decode_t * slow_q
            tt = tt * linkf
            ready = t_eff + self.up[i, p]
        else:
            ready = arrival + self.up[i, p]
        s_p = int(np.argmin(slots[node_p]))
        start_p = max(ready, slots[node_p][s_p])
        wait_p = start_p - ready
        finish_p = start_p + prefill_eff
        # colocated: one slot holds the whole service; split: the prefill
        # slot frees at finish_p and the decode leg queues on node_q
        slots[node_p][s_p] = finish_p + decode_t if colo else finish_p
        if colo:
            finish_d = finish_p + decode_t
            wait_d = 0.0
            transfer = 0.0
        else:
            ready_d = finish_p + tt
            s_q = int(np.argmin(slots[node_q]))
            start_d = max(ready_d, slots[node_q][s_q])
            wait_d = start_d - ready_d
            finish_d = start_d + decode_t
            slots[node_q][s_q] = finish_d
            transfer = tt
        completion = finish_d + self.down[i, qd]
        self._cache_admit(cache, i, node_p)
        self._cache_admit(cache, i, node_q)
        if tracer.enabled:
            # phase durations sum to completion - arrival exactly: upload,
            # prefill queue-wait, prefill, (transfer, decode queue-wait),
            # decode, download (span conservation, tests/test_obs.py)
            tracer.event(i, "dispatch", arrival, node=node_p, pair=p)
            tracer.phase(i, "upload", arrival, float(self.up[i, p]), node_p)
            tracer.phase(i, "queue-wait", ready, wait_p, node_p)
            tracer.phase(i, "prefill", start_p, prefill_eff, node_p)
            if not colo:
                tracer.event(i, "handoff-start", finish_p, node=node_p,
                             decode_node=node_q)
                tracer.phase(i, "kv-transfer", finish_p, tt, node_q)
                tracer.phase(i, "queue-wait-decode", finish_p + tt, wait_d,
                             node_q)
            tracer.phase(i, "decode", finish_d - decode_t, decode_t, node_q)
            tracer.phase(i, "download", finish_d, float(self.down[i, qd]),
                         node_q)
            tracer.event(i, "complete", completion, node=node_q)
            tracer.end(i, completion, "completed")
        return {"pair": qd, "pp": p, "lp": node_p, "lq": node_q,
                "hf": hf, "cost": cost_i,
                "wait": wait_p + wait_d,
                "ttft": (start_p + prefill_eff) - arrival,
                "transfer": transfer, "completion": completion,
                "q": self.quality[i, qd],
                "tpot": self.tpot_pair[qd] * slow_q,
                "busy": ((node_p, prefill_eff), (node_q, decode_t))}

    def run(self, assign: Optional[Sequence[int]] = None,
            concurrency: int = 1,
            down_nodes: Optional[Dict[int, Tuple[float, float]]] = None,
            on_failure: Optional[Callable[[int, int], int]] = None,
            arrivals: Optional[Sequence[float]] = None,
            policy: Optional[str] = None, genome=None,
            tracer=None, audit=None, metrics=None,
            learn_state=None) -> SimResult:
        """Execute the trace under assignment ``assign``, or — with
        ``policy=``/``genome=`` — decide each request in-loop through the
        RoutingPolicy registry (the DES twin of the JAX scan's in-scan
        decisions).

        down_nodes: {node: (t_down, t_up)} crash windows. A request dispatched
        to a crashed node invokes ``on_failure(request, node) -> new_pair``
        (default: retry on the cloud fallback), modeling the reroute-on-
        failure behaviour of the runtime router.

        arrivals: optional (I,) sorted timestamps — **open-loop** mode:
        request i enters the system at ``arrivals[i]`` regardless of earlier
        completions (``concurrency`` is ignored; node capacity still queues).
        Defaults to the trace's own ``arrival_time`` when it carries one.

        tracer/audit/metrics: optional ``repro.obs`` sinks — per-request
        lifecycle spans (simulated-seconds clock), per-decision audit
        records, and a vectorized post-run metrics ingest. All default to
        zero-overhead no-ops.

        learn_state: optional estimator state (``ClusterSimulator(
        learned=True)`` only) carried in from a previous window's
        ``SimResult.learn_state`` — cold-starts neutral when omitted.
        """
        I = self.trace.n_requests
        G = concurrency
        n_nodes = len(self.cluster.nodes)
        down_nodes = down_nodes or {}
        tracer = NOOP_TRACER if tracer is None else tracer
        pol, g, pstate = self._resolve_policy(policy, genome, assign)
        lstate = self._learn_init(pol, learn_state)
        est_p = np.zeros(I); est_t = np.zeros(I)
        real_p = np.zeros(I); real_t = np.zeros(I)
        if arrivals is None and self.trace.has_arrivals:
            arrivals = self.trace.arrival_time
        if arrivals is not None:
            arrivals = np.asarray(arrivals, np.float64)
            assert arrivals.shape == (I,)
            # index order must equal time order or this loop oracle would
            # silently disagree with the event-heap oracle
            assert (np.diff(arrivals) >= 0).all(), "arrivals must be sorted"

        # slot free-times per node (the capacity C_j resource)
        slots: List[List[float]] = [
            [0.0] * int(self.node_conc[n]) for n in range(n_nodes)]
        client_ready = [0.0] * G

        q = np.zeros(I)
        cost = np.zeros(I)
        rt = np.zeros(I)
        wait = np.zeros(I)
        ttft = np.zeros(I)
        tpot = np.zeros(I)
        hit = np.zeros(I)
        transfer = np.zeros(I)
        out_assign = np.zeros(I, np.int64)
        busy = np.zeros(n_nodes)
        cache = self._cache_state()

        for i in range(I):
            c = i % G
            arrival = (float(arrivals[i]) if arrivals is not None
                       else client_ready[c])
            fc = self._fault_ctx(i, arrival)
            t_dec = arrival if fc is None else fc[0]
            if pol is not None:
                busy_slots = [sum(1 for f in slots[n] if f > t_dec)
                              for n in range(n_nodes)]
                inp = self._policy_inputs(
                    i, busy_slots, cache, t_dec,
                    avail=None if fc is None else fc[1], lstate=lstate)
                pair = int(pol.decide_py(g, inp, self.np_arrays, pstate))
            else:
                inp = None
                pair = int(assign[i])
            raw = pair
            fault_failover = None
            if fc is not None:
                pair, fo = self._fault_failover(pair, fc[1])
                if fo:
                    fault_failover = "fault-node-down"

            if self.disaggregated:
                # ``pair`` is a route index here; crash windows on either
                # endpoint fall back to a colocated route
                route = pair
                failover = fault_failover
                a_ = self.np_arrays
                ends = {int(self.pair_node[a_.route_prefill[route]]),
                        int(self.pair_node[a_.route_decode[route]])}
                for nd in sorted(ends):
                    if nd in down_nodes:
                        t_down, t_up = down_nodes[nd]
                        if t_down <= arrival < t_up:
                            fb = (on_failure(i, nd)
                                  if on_failure is not None
                                  else int(self.arrays.cloud_fallback_pair))
                            route = self._colo_route.get(int(fb), route)
                            failover = "route-endpoint-down"
                            break
                self._trace_issue(tracer, audit, i, arrival, pol, g, inp,
                                  raw, route, failover)
                row = self._disagg_exec(cache, i, route, slots, arrival,
                                        tracer=tracer, fc=fc)
                client_ready[c] = row["completion"]
                if pol is not None:
                    pstate = pol.update_py(g, pstate, inp, row["pair"],
                                           row["cost"])
                if lstate is not None:
                    lstate = self._learn_after_disagg(
                        lstate, i, inp, row, fc, est_p, est_t, real_p,
                        real_t)
                q[i] = row["q"]; cost[i] = row["cost"]
                rt[i] = row["completion"] - arrival
                wait[i] = row["wait"]; ttft[i] = row["ttft"]
                tpot[i] = row["tpot"]; hit[i] = row["hf"]
                transfer[i] = row["transfer"]
                out_assign[i] = route
                for nd, dur in row["busy"]:
                    busy[nd] += dur
                continue
            node = int(self.pair_node[pair])

            failover = fault_failover
            if node in down_nodes:
                t_down, t_up = down_nodes[node]
                if t_down <= arrival < t_up:
                    pair = (on_failure(i, node) if on_failure is not None
                            else int(self.arrays.cloud_fallback_pair))
                    node = int(self.pair_node[pair])
                    failover = "node-down"
            self._trace_issue(tracer, audit, i, arrival, pol, g, inp, raw,
                              pair, failover)

            hf, service_i, prefill_i, cost_i = self._discounted(cache, i,
                                                                pair)
            slow_n = 1.0
            if fc is not None:
                slow_n = float(fc[2][node])
                service_i = service_i * slow_n
                prefill_i = prefill_i * slow_n
                ready = fc[0] + self.up[i, pair]
            else:
                ready = arrival + self.up[i, pair]
            s = int(np.argmin(slots[node]))
            start = max(ready, slots[node][s])
            finish = start + service_i
            completion = finish + self.down[i, pair]
            slots[node][s] = finish
            client_ready[c] = completion
            self._cache_admit(cache, i, node)
            if pol is not None:
                pstate = pol.update_py(g, pstate, inp, pair, cost_i)
            if lstate is not None:
                lstate = self._learn_after_colo(
                    lstate, i, inp, pair, node, slow_n, est_p, est_t,
                    real_p, real_t)

            q[i] = self.quality[i, pair]
            cost[i] = cost_i
            rt[i] = completion - arrival
            wait[i] = start - ready
            # first token leaves prefill at start + (uncached) prefill_time
            ttft[i] = (start + prefill_i) - arrival
            tpot[i] = self.tpot_pair[pair] * slow_n
            hit[i] = hf
            out_assign[i] = pair
            busy[node] += service_i
            self._trace_colo(tracer, i, arrival, pair, node, wait[i],
                             prefill_i, service_i - prefill_i, completion)

        extra = ({"est_prefill": est_p, "est_tpot": est_t,
                  "real_prefill": real_p, "real_tpot": real_t,
                  "learn_state": lstate} if lstate is not None else {})
        res = SimResult(q=q, cost=cost, rt=rt, assign=out_assign, wait=wait,
                        node_busy_time=busy, ttft=ttft, tpot=tpot, hit=hit,
                        transfer=transfer, **extra)
        self._record_metrics(metrics, res)
        return res

    # -- event-heap variant -------------------------------------------------
    def run_event_heap(self, assign: Optional[Sequence[int]] = None,
                       concurrency: int = 1,
                       arrivals: Optional[Sequence[float]] = None,
                       policy: Optional[str] = None, genome=None,
                       tracer=None, audit=None, metrics=None,
                       learn_state=None) -> SimResult:
        """Same semantics via an explicit event heap (belt-and-braces oracle:
        two independent queueing implementations must agree). With
        ``arrivals`` (or a trace carrying ``arrival_time``) every request's
        issue event is scheduled at its own timestamp — open-loop mode.
        ``policy=``/``genome=`` decide each request at issue time through the
        RoutingPolicy registry instead of a fixed ``assign``."""
        I = self.trace.n_requests
        G = concurrency
        n_nodes = len(self.cluster.nodes)
        tracer = NOOP_TRACER if tracer is None else tracer
        pol, g, pstate = self._resolve_policy(policy, genome, assign)
        lstate = self._learn_init(pol, learn_state)
        if arrivals is None and self.trace.has_arrivals:
            arrivals = self.trace.arrival_time

        q = np.zeros(I); cost = np.zeros(I); rt = np.zeros(I)
        wait = np.zeros(I); out_assign = np.zeros(I, np.int64)
        ttft = np.zeros(I); tpot = np.zeros(I); hit = np.zeros(I)
        transfer = np.zeros(I)
        est_p = np.zeros(I); est_t = np.zeros(I)
        real_p = np.zeros(I); real_t = np.zeros(I)
        busy = np.zeros(n_nodes)
        cache = self._cache_state()

        # events: (time, seq, kind, payload)
        heap: List[Tuple[float, int, str, tuple]] = []
        seq = 0
        node_free: List[List[float]] = [
            [0.0] * int(self.node_conc[n]) for n in range(n_nodes)]
        if arrivals is not None:
            arrivals = np.asarray(arrivals, np.float64)
            assert arrivals.shape == (I,)
            assert (np.diff(arrivals) >= 0).all(), "arrivals must be sorted"
            for i in range(I):
                heapq.heappush(heap, (float(arrivals[i]), seq, "issue",
                                      (i, None))); seq += 1
            issued = I
        else:
            next_req = [c for c in range(min(G, I))]
            for c, i in enumerate(next_req):
                heapq.heappush(heap, (0.0, seq, "issue", (i, c))); seq += 1
            issued = min(G, I)

        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if kind == "issue":
                i, c = payload
                fc = self._fault_ctx(i, t)
                t_dec = t if fc is None else fc[0]
                if pol is not None:
                    busy_slots = [sum(1 for f in node_free[n] if f > t_dec)
                                  for n in range(n_nodes)]
                    inp = self._policy_inputs(
                        i, busy_slots, cache, t_dec,
                        avail=None if fc is None else fc[1], lstate=lstate)
                    pair = int(pol.decide_py(g, inp, self.np_arrays, pstate))
                else:
                    inp = None
                    pair = int(assign[i])
                raw = pair
                fault_failover = None
                if fc is not None:
                    pair, fo = self._fault_failover(pair, fc[1])
                    if fo:
                        fault_failover = "fault-node-down"
                self._trace_issue(tracer, audit, i, t, pol, g, inp, raw,
                                  pair, fault_failover)
                if self.disaggregated:
                    row = self._disagg_exec(cache, i, pair, node_free, t,
                                            tracer=tracer, fc=fc)
                    if pol is not None:
                        pstate = pol.update_py(g, pstate, inp, row["pair"],
                                               row["cost"])
                    if lstate is not None:
                        lstate = self._learn_after_disagg(
                            lstate, i, inp, row, fc, est_p, est_t, real_p,
                            real_t)
                    q[i] = row["q"]; cost[i] = row["cost"]
                    rt[i] = row["completion"] - t
                    wait[i] = row["wait"]; ttft[i] = row["ttft"]
                    tpot[i] = row["tpot"]; hit[i] = row["hf"]
                    transfer[i] = row["transfer"]
                    out_assign[i] = pair
                    for nd, dur in row["busy"]:
                        busy[nd] += dur
                    heapq.heappush(heap, (row["completion"], seq, "done",
                                          (i, c))); seq += 1
                    continue
                node = int(self.pair_node[pair])
                hf, service_i, prefill_i, cost_i = self._discounted(cache, i,
                                                                    pair)
                slow_n = 1.0
                if fc is not None:
                    slow_n = float(fc[2][node])
                    service_i = service_i * slow_n
                    prefill_i = prefill_i * slow_n
                ready = t_dec + self.up[i, pair]
                s = int(np.argmin(node_free[node]))
                start = max(ready, node_free[node][s])
                finish = start + service_i
                node_free[node][s] = finish
                completion = finish + self.down[i, pair]
                self._cache_admit(cache, i, node)
                if pol is not None:
                    pstate = pol.update_py(g, pstate, inp, pair, cost_i)
                if lstate is not None:
                    lstate = self._learn_after_colo(
                        lstate, i, inp, pair, node, slow_n, est_p, est_t,
                        real_p, real_t)
                q[i] = self.quality[i, pair]; cost[i] = cost_i
                rt[i] = completion - t; wait[i] = start - ready
                ttft[i] = (start + prefill_i) - t
                tpot[i] = self.tpot_pair[pair] * slow_n; hit[i] = hf
                out_assign[i] = pair; busy[node] += service_i
                self._trace_colo(tracer, i, t, pair, node, wait[i],
                                 prefill_i, service_i - prefill_i,
                                 completion)
                heapq.heappush(heap, (completion, seq, "done", (i, c))); seq += 1
            else:  # done -> closed-loop client issues its next request
                _, c = payload
                if c is not None and issued < I:
                    heapq.heappush(heap, (t, seq, "issue", (issued, c)))
                    seq += 1; issued += 1

        extra = ({"est_prefill": est_p, "est_tpot": est_t,
                  "real_prefill": real_p, "real_tpot": real_t,
                  "learn_state": lstate} if lstate is not None else {})
        res = SimResult(q=q, cost=cost, rt=rt, assign=out_assign, wait=wait,
                        node_busy_time=busy, ttft=ttft, tpot=tpot, hit=hit,
                        transfer=transfer, **extra)
        self._record_metrics(metrics, res)
        return res
