"""Population trace evaluation for NSGA-II fitness (paper §IV-B.2), on tensors.

The evaluator turns a routing decision for every request of the trace into
the three objectives (RQ, C, RT) of Eqs. (2)–(4), and with per-request
deadlines on the trace (``workload.slo``) the SLO violation rate as a fourth
(``objectives="qoe"``). Three execution models:

* ``mode="eq5"`` — the paper's Eq. (5) exactly: RT_i = upload + T_infer +
  download, no queueing (what Table II measures at concurrency 1);
* ``mode="queued"`` — closed loop with G concurrent clients and per-node
  execution slots (capacity C_j): requests wait for a free slot, and a wait
  beyond the W_MAX stability bound counts as constraint violation;
* ``mode="open"`` — open loop: request i enters at the trace's
  ``arrival_time[i]`` (``workload.arrivals``) instead of being released by
  a client; queueing as in ``queued``. The regime the rolling-horizon
  re-fit (``core.router.maybe_reoptimize``) adapts to.

Four models switch on beside them, as in the reference:

* ``prefix_cache`` (open-loop session traces): a whole-block prefix served
  on a node stays cached there, per (node × session) and (node × system
  prompt); a later request sharing it pays only the uncached fraction of
  its prefill and a discounted price for cached prompt tokens, whichever
  policy routed it (the ``affinity`` policy also *sees* the hit fractions);
* ``disaggregated``: decisions index the cluster's (prefill, decode) route
  table; a split route holds a slot on each leg's node and pays a KV
  transfer between them;
* ``faulty`` (``TraceEvaluator(faults=...)``): crashed nodes are masked out
  of the policy's view with the router's sentinels and failed over,
  stragglers stretch service time, link flaps stretch KV transfers and
  transient errors delay the effective arrival;
* ``learned``: per-(node, category) residual estimators correct the
  policy's estimate rows and learn from each dispatched request.

The port of ``repro.core.fitness``. Where the reference vmaps a ``lax.scan``
over genomes, the port keeps a leading population dimension P and loops over
the requests in Python: one step advances the state of all P genomes at
once (queues, cached prefixes, the policy's and the estimators' state), so
a population's fitness costs I steps of a few dozen small tensor ops,
whatever P is. Decisions happen inside the loop (they read the live state)
and go through the policy registry (``core.policies``). Where two writes of
one step may land in one cell (a colocated route's two legs), they are
applied one after another in the reference's order.

Everything static per (trace × cluster) is precomputed into ``EvalTables``
in numpy with the reference's formulas and types, and moved to the device
last, so the tables are bit-equal to the reference's.

Bucketing (``TraceEvaluator(bucket="pow2")``) pads the tables to a size
bucket with a validity mask, as the reference does so that one compiled
program serves every re-fit window. The loop skips the padded rows: they
occupy no slot, leave the policy state alone and give exact zeros (assign
-1), and the objectives are masked means, so a padded run gives the
unpadded run's rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import Device, resolve, tensors
from ..cluster.spec import TASKS, ClusterArrays, ClusterSpec
from ..faults import (FaultSchedule, link_slowdown_torch,
                      node_available_torch, node_slowdown_torch,
                      torch_tables, transient_delay_torch)
from ..learn import LearnConfig
from ..learn import estimators as learn_est
from ..workload.trace import Trace
from .objectives import slo_ok
from .policies import PolicyInputs, get_policy
from .policies.affinity import CACHED_TOKEN_PRICE_FACTOR

# fault-masking sentinels — the runtime router uses the same constants for
# dead nodes (core/router.py), so masked PolicyInputs agree across layers
DEAD_QUEUE = 10**6
DEAD_UP = 1e9

RESP_BYTES_PER_TOKEN = 4.2  # avg UTF-8 payload bytes per generated token


class EvalTables(NamedTuple):
    """(I, n_pairs) static tables + per-request arrays for the evaluator."""

    quality: torch.Tensor       # realized q(r_i, pair)
    quality_mean: torch.Tensor  # noise-free E[q(r_i, pair)]
    cost: torch.Tensor          # Eq. 3 per-request cost
    service: torch.Tensor       # T_infer (prefill + decode)
    up_time: torch.Tensor       # Q_size/B_up + latency_up
    down_time: torch.Tensor     # R_size/B_down + latency_down
    # phase split (QoE accounting)
    prefill_time: torch.Tensor  # (I, n_pairs) prompt/prefill_tps
    tpot: torch.Tensor          # (n_pairs,) decode seconds per output token
    # per-request features for in-loop routing (threshold policies)
    complexity: torch.Tensor    # (I,)
    pred_category: torch.Tensor  # (I,) int32 (0=code, 1=math, 2=general)
    pred_conf: torch.Tensor     # (I,)
    # per-request QoE contract (+inf when the trace carries no SLOs)
    ttft_deadline: torch.Tensor  # (I,)
    tpot_deadline: torch.Tensor  # (I,)
    # open-loop arrival timestamps (zeros when the trace is closed-loop)
    arrival_time: torch.Tensor  # (I,)
    # prefix-cache model inputs (session traces; degenerate otherwise)
    prompt_cost: torch.Tensor   # (I, n_pairs) prompt-only part of `cost`
    prompt_tokens: torch.Tensor  # (I,)
    group_id: torch.Tensor      # (I,) int32 session id, -1 = single-shot
    sys_id: torch.Tensor        # (I,) int32 shared-system-prompt id, -1=none
    sys_tokens: torch.Tensor    # (I,)
    # bucketing mask: False rows are padding appended by ``pad_tables``
    valid: torch.Tensor         # (I,) bool


def request_pair_estimates(prompt_tokens: float, resp_tokens_mean: float,
                           query_bytes: float, arrays: ClusterArrays
                           ) -> dict:
    """Per-pair phase/cost estimates for ONE request (numpy, router hot path).

    Returns float32 (n_pairs,) vectors ``up``, ``prefill``, ``tpot``,
    ``cost`` using the same formulas as ``build_tables`` so the runtime
    router's SLO decisions agree with the offline evaluator. ``arrays`` holds
    numpy arrays (or CPU tensors).
    """
    verb = np.asarray(arrays.pair_verbosity, np.float32)
    resp_tokens = np.maximum(np.round(np.float32(resp_tokens_mean) * verb), 1.0)
    price = np.asarray(arrays.pair_price, np.float32)
    cost = (np.float32(prompt_tokens) + resp_tokens) / 1e6 * price
    prompt_cost = np.float32(prompt_tokens) / np.float32(1e6) * price
    prefill = np.float32(prompt_tokens) / np.asarray(arrays.pair_prefill_tps,
                                                     np.float32)
    tpot = np.float32(1.0) / np.asarray(arrays.pair_decode_tps, np.float32)
    node = np.asarray(arrays.pair_node)
    up = (np.float32(query_bytes) / np.asarray(arrays.node_bw_up,
                                               np.float32)[node]
          + np.asarray(arrays.node_lat_up, np.float32)[node])
    return {"up": up.astype(np.float32), "prefill": prefill.astype(np.float32),
            "tpot": tpot.astype(np.float32), "cost": cost.astype(np.float32),
            "prompt_cost": prompt_cost.astype(np.float32)}


def build_tables_numpy(trace: Trace, cluster: ClusterSpec, seed: int = 0
                       ) -> Tuple[dict, dict]:
    """Every ``EvalTables`` and ``ClusterArrays`` field as numpy, computed
    as the reference's ``build_tables`` computes it (float64 intermediates,
    then f32)."""
    arrays = cluster.arrays_numpy()
    I = trace.n_requests
    Pn = arrays["pair_node"].shape[0]

    task = trace.task                          # (I,)
    prompt = trace.prompt_tokens.astype(np.float32)
    resp_mean = trace.resp_tokens_mean
    difficulty = trace.difficulty
    qbytes = trace.query_bytes

    verb = arrays["pair_verbosity"]            # (Pn,)
    resp_tokens = np.maximum(np.round(resp_mean[:, None] * verb[None, :]), 1.0)

    price = arrays["pair_price"]
    total_tokens = prompt[:, None] + resp_tokens
    cost = total_tokens / 1e6 * price[None, :]                     # Eq. 3

    prefill = prompt[:, None] / arrays["pair_prefill_tps"][None, :]
    decode = resp_tokens / arrays["pair_decode_tps"][None, :]
    service = prefill + decode
    tpot = 1.0 / arrays["pair_decode_tps"]

    node = arrays["pair_node"]
    up = (qbytes[:, None] / arrays["node_bw_up"][node][None, :]
          + arrays["node_lat_up"][node][None, :])
    resp_bytes = resp_tokens * RESP_BYTES_PER_TOKEN
    down = (resp_bytes / arrays["node_bw_down"][node][None, :]
            + arrays["node_lat_down"][node][None, :])

    base_q = arrays["pair_base_quality"]       # (Pn, n_tasks)
    slope = arrays["pair_diff_slope"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 777]))
    noise = rng.normal(0.0, 0.05, size=(I, Pn)).astype(np.float32)
    q_mean = base_q.T[task, :] + slope[None, :] * (0.5 - difficulty[:, None])
    quality = np.clip(q_mean + noise, 0.0, 1.0)
    quality_mean = np.clip(q_mean, 0.0, 1.0)

    if trace.has_slos:
        ttft_dl, tpot_dl = trace.ttft_deadline, trace.tpot_deadline
    else:
        ttft_dl = np.full(I, np.inf, np.float32)
        tpot_dl = np.full(I, np.inf, np.float32)

    f32 = np.float32
    tables = dict(
        quality=quality.astype(f32),
        quality_mean=quality_mean.astype(f32),
        cost=cost.astype(f32),
        service=service.astype(f32),
        up_time=up.astype(f32),
        down_time=down.astype(f32),
        prefill_time=prefill.astype(f32),
        tpot=tpot.astype(f32),
        complexity=trace.complexity.astype(f32),
        pred_category=trace.pred_category.astype(np.int32),
        pred_conf=trace.pred_conf.astype(f32),
        ttft_deadline=np.asarray(ttft_dl, f32),
        tpot_deadline=np.asarray(tpot_dl, f32),
        arrival_time=np.asarray(trace.arrival_time if trace.has_arrivals
                                else np.zeros(I), f32),
        prompt_cost=(prompt[:, None] / 1e6 * price[None, :]).astype(f32),
        prompt_tokens=prompt.astype(f32),
        group_id=np.asarray(trace.group_id if trace.has_sessions
                            else -np.ones(I), np.int32),
        sys_id=np.asarray(trace.sys_id if trace.sys_id is not None
                          else -np.ones(I), np.int32),
        sys_tokens=np.asarray(trace.sys_tokens if trace.sys_tokens is not None
                              else np.zeros(I), f32),
        valid=np.ones((I,), bool),
    )
    return tables, arrays


def build_tables(trace: Trace, cluster: ClusterSpec, seed: int = 0,
                 device: Device = None) -> Tuple[EvalTables, ClusterArrays]:
    """Precompute all queue-independent quantities on the host, then move
    them to ``device``."""
    tables, arrays = build_tables_numpy(trace, cluster, seed)
    return (tensors(EvalTables, tables, device),
            tensors(ClusterArrays, arrays, device))


# ---------------------------------------------------------------------------
# Bucketing: the reference pads a re-fit window to a size bucket so that one
# compiled program serves every window; the port keeps the same tables and
# masks so the two agree row for row.
# ---------------------------------------------------------------------------

def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def bucket_size(n: int, bucket) -> int:
    """Padded length for ``n`` requests: "pow2" -> next power of two (the
    router's bucket; the reference's integer buckets have no caller)."""
    if bucket != "pow2":
        raise ValueError(f"bucket must be 'pow2', got {bucket!r}")
    return next_pow2(n)


def pad_tables(tables: EvalTables, n: int) -> EvalTables:
    """Pad every per-request tensor of ``tables`` to ``n`` rows, marking the
    tail invalid. Padded rows carry neutral values (zeros, ``+inf``
    deadlines, the last arrival repeated) but the ``valid`` mask is what
    keeps them out of objectives and loop state."""
    I = int(tables.quality.shape[0])
    assert n >= I, f"bucket {n} smaller than trace ({I})"
    if n == I:
        return tables
    pad = n - I

    def rows(a, value=0):
        tail = torch.full((pad,) + tuple(a.shape[1:]), value, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail])

    at = tables.arrival_time
    return tables._replace(
        quality=rows(tables.quality),
        quality_mean=rows(tables.quality_mean),
        cost=rows(tables.cost),
        service=rows(tables.service),
        up_time=rows(tables.up_time),
        down_time=rows(tables.down_time),
        prefill_time=rows(tables.prefill_time),
        complexity=rows(tables.complexity),
        pred_category=rows(tables.pred_category),
        pred_conf=rows(tables.pred_conf),
        ttft_deadline=rows(tables.ttft_deadline, float("inf")),
        tpot_deadline=rows(tables.tpot_deadline, float("inf")),
        arrival_time=torch.cat([at, at[-1:].expand(pad)]),
        prompt_cost=rows(tables.prompt_cost),
        prompt_tokens=rows(tables.prompt_tokens),
        group_id=rows(tables.group_id, -1),
        sys_id=rows(tables.sys_id, -1),
        sys_tokens=rows(tables.sys_tokens),
        valid=rows(tables.valid, False),
    )


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    concurrency: int = 1          # G closed-loop clients (ignored by "open")
    mode: str = "queued"          # "eq5" | "queued" | "open"
    w_max: float = 30.0           # stability bound: wait beyond this = violation
    # prefix-cache model (session traces, open-loop only: the cache state
    # evolves in dispatch order)
    prefix_cache: bool = False
    cache_block: int = 16         # whole-block sharing granularity (tokens)
    # disaggregated prefill/decode: decisions index the cluster's route
    # table (route-valued policies, ``RoutingPolicy.decides == "route"``);
    # split routes pay a KV-transfer phase between the prefill finish and
    # the decode start, sized prompt_blocks × bytes_per_block over the
    # node-to-node KV link
    disaggregated: bool = False
    # fault injection (repro_torch.faults): crashed nodes are masked out of
    # PolicyInputs (DEAD_QUEUE/DEAD_UP, the router's own sentinels) with a
    # deterministic failover, stragglers stretch service time, link flaps
    # stretch KV transfers, and transient errors delay the effective arrival
    faulty: bool = False
    # online-learned estimators (repro_torch.learn): a per-(node, category)
    # residual-estimator state per genome overrides the prefill/tpot
    # estimate rows of PolicyInputs (and fills the quality/unc rows), and is
    # updated from each dispatched request's realized observations. Zero
    # residuals reproduce the static rows bitwise.
    learned: bool = False
    learner: LearnConfig = LearnConfig()

    def __post_init__(self):
        assert self.mode in ("eq5", "queued", "open"), self.mode
        assert self.concurrency >= 1
        assert not self.prefix_cache or self.open_loop, \
            "prefix_cache needs open-loop traces (deterministic cache order)"

    @property
    def open_loop(self) -> bool:
        return self.mode == "open"

    @property
    def is_eq5(self) -> bool:
        return self.mode == "eq5"


class EvalResult(NamedTuple):
    """Per-request outcomes, (P, I) for a population or (I,) for one run."""

    q: torch.Tensor        # realized quality
    cost: torch.Tensor
    rt: torch.Tensor
    assign: torch.Tensor   # int32 chosen pair (or route when disaggregated)
    violation: torch.Tensor  # (P,) or scalar: summed wait beyond w_max
    ttft: torch.Tensor     # time to first token (up + wait + prefill)
    tpot: torch.Tensor     # decode seconds per output token
    hit: torch.Tensor      # realized cached-prefix fraction (0 w/o cache)
    # KV-transfer seconds between prefill finish and decode start; exactly
    # 0 on colocated routes and in non-disaggregated evaluation
    transfer: torch.Tensor

    def row(self, p: int) -> "EvalResult":
        return EvalResult(*(t[p] for t in self))


def _max_conc(arrays: ClusterArrays) -> int:
    return int(arrays.node_conc.max())


def _run_trace(genomes: torch.Tensor, policy: str, tables: EvalTables,
               arrays: ClusterArrays, cfg: EvalConfig, n_slots: int,
               n_groups: Tuple[int, int] = (1, 1),
               faults=None) -> EvalResult:
    """Route the whole trace for P genomes at once; (P, I) outputs.

    ``n_groups`` sizes the prefix-cache state (sessions, system prompts);
    ``faults`` is a ``FaultTables`` of tensors (``cfg.faulty``). Rows that
    ``tables.valid`` marks as padding (read to the host once, with the
    request's session, system prompt and category) are skipped: they occupy
    no slot, leave the clients, the cached prefixes, the policy's and the
    estimators' state alone, and keep their zeros and ``assign = -1``."""
    pol = get_policy(policy)
    dev = genomes.device
    P = genomes.shape[0]
    I = tables.quality.shape[0]
    G = cfg.concurrency
    n_nodes = arrays.node_conc.shape[0]
    f32 = torch.float32
    blk = float(cfg.cache_block)

    # slot_free[p, n, s] = time when slot s of node n becomes free under
    # genome p; slots beyond a node's concurrency stay at +inf (never chosen)
    slot_valid = (torch.arange(n_slots, device=dev)[None, :]
                  < arrays.node_conc[:, None])
    slot_free = torch.where(slot_valid, 0.0, float("inf")).to(f32)
    slot_free = slot_free.expand(P, -1, -1).clone()
    client_ready = torch.zeros((P, G), dtype=f32, device=dev)
    # cached-prefix tokens resident per (node, session) / (node, sys prompt)
    c_sess = torch.zeros((P, n_nodes, n_groups[0]), dtype=f32, device=dev)
    c_sys = torch.zeros((P, n_nodes, n_groups[1]), dtype=f32, device=dev)
    pstate = torch.as_tensor(pol.init_state(), dtype=f32, device=dev)
    pstate = pstate.expand(P, -1).clone()
    if cfg.learned:
        lstate = torch.as_tensor(learn_est.init_state(cfg.learner, n_nodes),
                                 device=dev).expand(P, -1).clone()
    rows = torch.arange(P, device=dev)
    pair_node = arrays.pair_node.long()
    zeros_pairs = torch.zeros_like(tables.tpot)
    if cfg.faulty:
        delays = transient_delay_torch(faults, torch.arange(I, device=dev))
    if cfg.disaggregated:
        rp, rq = arrays.route_prefill.long(), arrays.route_decode.long()
        route_rank = ((rp != rq).to(f32) * 1e6
                      + torch.arange(rp.shape[0], dtype=f32, device=dev))
    else:
        pair_rank = (arrays.pair_is_edge.to(f32) * 1e6
                     + torch.arange(pair_node.shape[0], dtype=f32,
                                    device=dev))

    q = torch.zeros((P, I), dtype=f32, device=dev)
    cost = torch.zeros_like(q)
    rt = torch.zeros_like(q)
    excess = torch.zeros_like(q)
    ttft = torch.zeros_like(q)
    tpot = torch.zeros_like(q)
    hit = torch.zeros_like(q)
    transfer = torch.zeros_like(q)
    assign = torch.full((P, I), -1, dtype=torch.int32, device=dev)

    host = zip(tables.valid.tolist(), tables.group_id.tolist(),
               tables.sys_id.tolist(), tables.pred_category.tolist())
    for i, (valid, g, y, cat) in enumerate(host):
        if not valid:
            continue
        if cfg.open_loop:
            arrival = tables.arrival_time[i].expand(P)
        else:
            arrival = client_ready[:, i % G]                  # (P,)

        if cfg.faulty:
            # transient error = the request's first dispatch fails and it
            # re-enters after a deterministic jittered backoff: decisions
            # and queue dynamics run at the *effective* arrival while
            # rt/ttft stay measured from the original arrival
            delay = delays[i]
            t_eff = arrival + delay
            avail = node_available_torch(faults, t_eff)       # (P, n_nodes)
            slow = node_slowdown_torch(faults, t_eff)         # (P, n_nodes)
            linkf = link_slowdown_torch(faults, t_eff)        # (P,)
        else:
            t_eff = arrival

        # monitor view: busy slots per node at arrival (the q_j feature)
        busy = (slot_valid & (slot_free > t_eff[:, None, None])
                ).sum(dim=2, dtype=torch.int32)               # (P, n_nodes)

        if cfg.prefix_cache:
            pt = tables.prompt_tokens[i]
            blk_p = torch.floor(pt / blk) * blk
            blk_s = torch.floor(tables.sys_tokens[i] / blk) * blk
            hit_node = torch.zeros((P, n_nodes), dtype=f32, device=dev)
            if g >= 0:
                hit_node = torch.minimum(c_sess[:, :, g], blk_p)
            if y >= 0:
                hit_node = torch.maximum(
                    hit_node, torch.minimum(c_sys[:, :, y], blk_s))
            hit_pair = (hit_node / torch.clamp(pt, min=1.0))[:, pair_node]
        else:
            hit_pair = zeros_pairs.expand(P, -1)

        # whole-block KV footprint per pair (route policies read it)
        if cfg.disaggregated:
            kv_blk = torch.floor(tables.prompt_tokens[i] / blk) * blk
            kv_bytes = kv_blk * arrays.pair_kv_bytes_per_token
        else:
            kv_bytes = zeros_pairs

        if cfg.faulty:
            # dead nodes are masked out of the policy's view with the
            # runtime router's own sentinels (core/router.py)
            busy_obs = torch.where(avail, busy, DEAD_QUEUE)
            up_obs = torch.where(avail[:, pair_node], tables.up_time[i],
                                 DEAD_UP)
        else:
            busy_obs = busy
            up_obs = tables.up_time[i]

        if cfg.learned:
            # override the static prefill / tpot estimate rows (and fill
            # quality/unc) from the residual posterior; zero residuals
            # reproduce the static rows bitwise
            x1, x2, x3 = learn_est.features(
                torch, tables.prompt_tokens[i], tables.complexity[i],
                busy_obs, arrays.node_conc)
            d_p, d_t, d_q, unc_n = learn_est.predict_torch(
                cfg.learner, lstate, n_nodes, cat, x1, x2, x3)
            prefill_row, tpot_row, quality_row, unc_row = \
                learn_est.corrected_rows(
                    torch, tables.prefill_time[i], tables.tpot,
                    tables.quality_mean[i], d_p, d_t, d_q, unc_n, pair_node)
        else:
            prefill_row = tables.prefill_time[i]
            tpot_row = tables.tpot
            quality_row = tables.quality_mean[i]
            unc_row = zeros_pairs

        inp = PolicyInputs(
            index=i, now=t_eff,
            complexity=tables.complexity[i],
            pred_category=tables.pred_category[i],
            pred_conf=tables.pred_conf[i],
            ttft_deadline=tables.ttft_deadline[i],
            tpot_deadline=tables.tpot_deadline[i],
            prompt_tokens=tables.prompt_tokens[i],
            up=up_obs, prefill=prefill_row, tpot=tpot_row,
            cost=tables.cost[i], prompt_cost=tables.prompt_cost[i],
            hit_frac=hit_pair, queue_len=busy_obs, kv_bytes=kv_bytes,
            quality=quality_row, unc=unc_row)
        decision = pol.decide_torch(genomes, inp, arrays, pstate)  # (P,)

        if cfg.faulty:
            # deterministic failover off crashed nodes: the lowest-index
            # alive colocated route (disaggregated) or cloud pair, else the
            # lowest alive index
            if cfg.disaggregated:
                dead = ~avail[:, pair_node[rp]] | ~avail[:, pair_node[rq]]
                rank = route_rank
            else:
                dead = ~avail[:, pair_node]
                rank = pair_rank
            fb = torch.argmin(torch.where(dead, float("inf"), rank), dim=1)
            decision = torch.where(dead[rows, decision], fb, decision)

        prefill_time = tables.prefill_time[i]
        if cfg.disaggregated:
            # decision indexes the route table: prefill leg on pair_p,
            # decode leg on pair_q, KV transfer between them when split
            pair_p, pair_q = rp[decision], rq[decision]
            colo = pair_p == pair_q
            node_p, node_q = pair_node[pair_p], pair_node[pair_q]
            up = tables.up_time[i][pair_p]
            down = tables.down_time[i][pair_q]
            hf = hit_pair[rows, pair_p]
            prefill = prefill_time[pair_p] * (1.0 - hf)
            decode_t = tables.service[i][pair_q] - prefill_time[pair_q]
            tt = (arrays.kv_lat[node_p, node_q]
                  + kv_bytes[pair_p] * arrays.kv_inv_bw[node_p, node_q])
            if cfg.faulty:
                # stragglers stretch each leg on its own node; link flaps
                # stretch the KV transfer (zero on colocated routes)
                prefill = prefill * slow[rows, node_p]
                decode_t = decode_t * slow[rows, node_q]
                tt = tt * linkf
            cost_i = (tables.prompt_cost[i][pair_p]
                      * (1.0 - hf * (1.0 - CACHED_TOKEN_PRICE_FACTOR))
                      + (tables.cost[i][pair_q]
                         - tables.prompt_cost[i][pair_q])
                      + kv_bytes[pair_p] * arrays.kv_egress[node_p, node_q])

            if cfg.is_eq5:
                rt_i = up + prefill + tt + decode_t + down
                if cfg.faulty:
                    rt_i = rt_i + delay
                completion = arrival + rt_i
                wait = torch.zeros_like(rt_i)
                ttft_i = up + prefill
            else:
                ready = t_eff + up
                slots_p = slot_free[rows, node_p]
                s_p = torch.argmin(slots_p, dim=1)
                start_p = torch.maximum(ready, slots_p[rows, s_p])
                wait_p = start_p - ready
                finish_p = start_p + prefill
                # colocated routes keep single-slot occupancy for the whole
                # service; split routes free the prefill slot at finish_p
                slot_free[rows, node_p, s_p] = torch.where(
                    colo, finish_p + decode_t, finish_p)
                ready_d = finish_p + tt
                slots_q = slot_free[rows, node_q]
                s_q = torch.argmin(slots_q, dim=1)
                start_d = torch.maximum(ready_d, slots_q[rows, s_q])
                finish_d = torch.where(colo, finish_p + decode_t,
                                       start_d + decode_t)
                slot_free[rows, node_q, s_q] = torch.where(
                    colo, slots_q[rows, s_q], finish_d)
                wait = wait_p + torch.where(colo, 0.0, start_d - ready_d)
                completion = finish_d + down
                rt_i = completion - arrival
                ttft_i = up + wait_p + prefill
            if cfg.faulty:
                ttft_i = ttft_i + delay

            transfer_i = torch.where(colo, 0.0, tt)
            q_i = tables.quality[i][pair_q]
            pair, node = pair_q, node_q      # billing pair for update hooks
            if cfg.prefix_cache:
                # the prefix becomes resident on the prefill node, and the
                # handoff replicates it onto the decode node
                for leg in (node_p, node_q):
                    if g >= 0:
                        c_sess[rows, leg, g] = torch.maximum(
                            c_sess[rows, leg, g], blk_p)
                    if y >= 0:
                        c_sys[rows, leg, y] = torch.maximum(
                            c_sys[rows, leg, y], blk_s)
        else:
            pair = decision
            node = pair_node[pair]
            up = tables.up_time[i][pair]
            down = tables.down_time[i][pair]
            service = tables.service[i][pair]
            prefill = prefill_time[pair]
            cost_i = tables.cost[i][pair]
            if cfg.prefix_cache:
                # the cache is physical: a hit shortens prefill (and node
                # occupancy) and discounts cached prompt tokens for whichever
                # policy routed here (with no cache the hit is 0 and these
                # are the plain values, bit for bit)
                hf = hit_pair[rows, pair]
                service = service - hf * prefill
                prefill = prefill * (1.0 - hf)
                cost_i = (cost_i - hf * (1.0 - CACHED_TOKEN_PRICE_FACTOR)
                          * tables.prompt_cost[i][pair])
            if cfg.faulty:
                # a straggling node executes the whole service slower
                service = service * slow[rows, node]
                prefill = prefill * slow[rows, node]

            if cfg.is_eq5:
                rt_i = up + service + down                # Eq. (5) verbatim
                if cfg.faulty:
                    rt_i = rt_i + delay
                completion = arrival + rt_i
                wait = torch.zeros_like(rt_i)
            else:
                ready = t_eff + up
                slots_n = slot_free[rows, node]               # (P, n_slots)
                s = torch.argmin(slots_n, dim=1)              # first minimum
                start = torch.maximum(ready, slots_n[rows, s])
                wait = start - ready
                finish = start + service
                completion = finish + down
                rt_i = completion - arrival
                slot_free[rows, node, s] = finish

            if cfg.prefix_cache:
                # this prompt's whole-block prefix is now resident on `node`
                if g >= 0:
                    c_sess[rows, node, g] = torch.maximum(
                        c_sess[rows, node, g], blk_p)
                if y >= 0:
                    c_sys[rows, node, y] = torch.maximum(
                        c_sys[rows, node, y], blk_s)

            ttft_i = up + wait + prefill
            if cfg.faulty:
                ttft_i = ttft_i + delay
            transfer_i = None
            q_i = tables.quality[i][pair]
        tpot_i = tables.tpot[pair]
        if cfg.faulty:
            tpot_i = tpot_i * slow[rows, node]

        client_ready[:, i % G] = completion
        pstate = pol.update_torch(genomes, pstate, inp, pair, cost_i)
        if cfg.learned:
            # feed the dispatched request's realized observations back into
            # the estimator state: prefill residual on the prefill node,
            # tpot + quality residuals on the decode node (same node when
            # colocated). Latency targets are speed ratios of the full
            # static phase time — exact zeros on fault-free runs.
            if cfg.disaggregated:
                obs_prefill = prefill_time[pair_p]
                node_a, node_b = node_p, node_q
            else:
                obs_prefill = prefill_time[pair]
                node_a = node_b = node
            if cfg.faulty:
                slow_a, slow_b = slow[rows, node_a], slow[rows, node_b]
            else:
                slow_a = slow_b = 1.0
            y_p, y_t, y_q = learn_est.observations(
                torch, obs_prefill, slow_a, tables.tpot[pair], slow_b,
                q_i, tables.quality_mean[i][pair])
            lstate = learn_est.update_torch(
                cfg.learner, lstate, n_nodes, cat, node_a, node_b,
                x1, x2, x3, y_p, y_t, y_q)
        q[:, i] = q_i
        cost[:, i] = cost_i
        rt[:, i] = rt_i
        assign[:, i] = decision.to(torch.int32)
        excess[:, i] = torch.clamp(wait - cfg.w_max, min=0.0)
        ttft[:, i] = ttft_i
        tpot[:, i] = tpot_i
        if cfg.prefix_cache:
            hit[:, i] = hf
        if transfer_i is not None:
            transfer[:, i] = transfer_i

    return EvalResult(q=q, cost=cost, rt=rt, assign=assign,
                      violation=excess.sum(dim=1), ttft=ttft, tpot=tpot,
                      hit=hit, transfer=transfer)


def _objectives(res: EvalResult, tables: EvalTables, objectives: str
                ) -> torch.Tensor:
    """(P, M) masked means over the valid requests: (RQ, C, RT), and the
    SLO violation rate V for ``objectives="qoe"``. Padded rows hold exact
    zeros, so the sums over the padded axis are the unpadded sums."""
    vf = tables.valid.to(torch.float32)
    n = torch.clamp(vf.sum(), min=1.0)
    F = [(vf - res.q).sum(dim=1) / n, res.cost.sum(dim=1) / n,
         res.rt.sum(dim=1) / n]
    if objectives == "qoe":
        ok = slo_ok(res.ttft, res.tpot, tables.ttft_deadline,
                    tables.tpot_deadline) & tables.valid
        F.append(1.0 - ok.to(torch.float32).sum(dim=1) / n)
    return torch.stack(F, dim=1)


def population_mesh(n_ranks: Optional[int] = None, device: Device = None):
    """1-D ``('pop',)`` ``DeviceMesh`` for population-sharded fitness
    (``make_fitness(..., mesh=)``) over ranks 0..n-1 of the initialized
    process group (default: all of them; every rank calls it). It runs on
    CUDA unless ``device`` names another."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device_type = resolve(device).type
    world = dist.get_world_size()
    n = world if n_ranks is None else min(int(n_ranks), world)
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("pop",))


def _sharded_fitness(fitness, mesh):
    """``fitness`` with the population split over the ranks of the 1-D
    ``mesh``: rows padded by repeating row 0 to a multiple of the rank
    count, each rank evaluating its contiguous block with ``fitness``,
    objectives and violations gathered back in row order and the padding
    dropped. Per-genome evaluation is independent of the other rows, so
    the result equals the unsharded one."""
    from torch.distributed.tensor import DTensor, Shard
    n = mesh.size()
    rank = mesh.get_local_rank()

    def sharded(genomes):
        genomes = torch.as_tensor(genomes)
        P = genomes.shape[0]
        P_pad = -(-P // n) * n
        if P_pad != P:
            fill = genomes[:1].expand((P_pad - P,) + genomes.shape[1:])
            genomes = torch.cat([genomes, fill], dim=0)
        block = P_pad // n
        F, viol = fitness(genomes[rank * block:(rank + 1) * block])
        gather = lambda t: DTensor.from_local(  # noqa: E731
            t.contiguous(), mesh, [Shard(0)], run_check=False).full_tensor()
        return gather(F)[:P], gather(viol)[:P]

    return sharded


class TraceEvaluator:
    """Evaluate routing decisions over a fixed (trace × cluster) on
    ``device`` (CUDA unless the caller asks for another).

    ``bucket="pow2"`` pads the tables to the next power of two over I with
    a validity mask, and the session/system-prompt counts to powers of two,
    as the reference's compile-once re-fit does; ``run_*`` results are
    sliced back to the ``n_valid`` real requests. ``faults`` (a
    ``FaultSchedule``) turns on ``EvalConfig.faulty``."""

    def __init__(self, trace: Trace, cluster: ClusterSpec,
                 cfg: EvalConfig = EvalConfig(), seed: int = 0,
                 bucket=None, faults: Optional[FaultSchedule] = None,
                 device: Device = None):
        assert not cfg.open_loop or trace.has_arrivals, \
            "mode='open' needs a trace with arrival_time (workload.arrivals)"
        assert not cfg.prefix_cache or trace.has_sessions, \
            "prefix_cache needs a session trace (workload.sessions)"
        self.device = resolve(device)
        self.trace = trace
        self.cluster = cluster
        if faults is not None:
            cfg = dataclasses.replace(cfg, faulty=True)
        assert not cfg.faulty or faults is not None, \
            "EvalConfig(faulty=True) needs a FaultSchedule"
        self.cfg = cfg
        self.tables, self.arrays = build_tables(trace, cluster, seed=seed,
                                                device=self.device)
        self.fault_tables = (
            torch_tables(faults.compile(len(cluster.nodes)), self.device)
            if faults is not None else None)
        self.n_slots = _max_conc(self.arrays)
        self.n_valid = trace.n_requests
        n_sess = int(np.max(trace.group_id)) + 2 if trace.has_sessions else 1
        n_sys = (int(np.max(trace.sys_id)) + 2
                 if trace.sys_id is not None else 1)
        if bucket is not None:
            self.tables = pad_tables(self.tables,
                                     bucket_size(self.n_valid, bucket))
            n_sess, n_sys = next_pow2(n_sess), next_pow2(n_sys)
        self.n_padded = int(self.tables.quality.shape[0])
        self.n_groups = (n_sess, n_sys)

    def _genomes(self, policy: str, genomes) -> torch.Tensor:
        spec = get_policy(policy).genome_spec
        dtype = torch.int32 if spec.discrete else torch.float32
        g = torch.as_tensor(genomes).to(device=self.device, dtype=dtype)
        assert g.dim() == 2, "genomes must be (P, D)"
        if spec.per_request and g.shape[1] < self.n_padded:
            # one gene per request: padded rows get gene 0, as the
            # reference pads them (their decisions are masked)
            g = torch.nn.functional.pad(g, (0, self.n_padded - g.shape[1]))
        return g

    def _check_decision_space(self, pol) -> None:
        """Route-valued policies need ``disaggregated=True`` and vice versa
        (per-request genomes may encode either index space)."""
        if pol.genome_spec.per_request:
            return
        want = "route" if self.cfg.disaggregated else "pair"
        assert pol.decides == want, \
            (f"policy {pol.name!r} decides over {pol.decides!r} indices but "
             f"EvalConfig(disaggregated={self.cfg.disaggregated}) evaluates "
             f"{want!r} decisions")

    # -- runs -----------------------------------------------------------------
    def _run(self, policy: str, genomes: torch.Tensor) -> EvalResult:
        """(P, n_padded) results over the (padded) tables."""
        return _run_trace(genomes, policy, self.tables, self.arrays, self.cfg,
                          self.n_slots, self.n_groups, self.fault_tables)

    def run_population(self, policy: str, genomes) -> EvalResult:
        """Evaluate P genomes of a registered policy: (P, I) results over
        the real requests."""
        self._check_decision_space(get_policy(policy))
        res = self._run(policy, self._genomes(policy, genomes))
        if self.n_padded == self.n_valid:
            return res
        n = self.n_valid
        return EvalResult(*(t if t.dim() == 1 else t[:, :n] for t in res))

    def run_policy(self, policy: str, genome) -> EvalResult:
        """Evaluate one genome of a registered policy: (I,) results."""
        return self.run_population(
            policy, torch.as_tensor(genome)[None]).row(0)

    def run_assignment(self, assign) -> EvalResult:
        return self.run_policy("direct", assign)

    def run_thresholds(self, thresholds) -> EvalResult:
        return self.run_policy("threshold", thresholds)

    def run_slo_policy(self, params) -> EvalResult:
        """Run the SLO-aware policy (genome = [γ, κ], see core.policies)."""
        return self.run_policy("slo", params)

    def run_affinity_policy(self, params) -> EvalResult:
        """Run the cache-affinity policy (genome = [γ, κ, ρ])."""
        return self.run_policy("affinity", params)

    # -- population fitness (for NSGA2) --------------------------------------
    def make_fitness(self, genome: str, objectives: str = "paper",
                     mesh=None):
        """Return a fitness function mapping (P, D) genomes to
        ((P, M) objectives, (P,) violation): M = 3 (RQ, C, RT) for
        ``objectives="paper"``; "qoe" appends the SLO violation rate as a
        4th minimized objective (the trace must carry deadlines). With
        ``mesh`` (``population_mesh``) the population is split over its
        ranks, each evaluating its block; every rank calls the function
        with the same genomes and gets every row."""
        assert objectives in ("paper", "qoe")
        assert objectives != "qoe" or self.trace.has_slos, \
            "qoe objectives need a trace with SLOs (workload.slo.attach_slos)"
        self._check_decision_space(get_policy(genome))  # validates the name

        def fitness(genomes: torch.Tensor):
            res = self._run(genome, self._genomes(genome, genomes))
            return _objectives(res, self.tables, objectives), res.violation

        return fitness if mesh is None else _sharded_fitness(fitness, mesh)

    # -- reporting ------------------------------------------------------------
    def summarize(self, res: EvalResult) -> dict:
        out = {
            "avg_quality": float(res.q.mean()),
            "avg_response_time": float(res.rt.mean()),
            "avg_cost": float(res.cost.mean()),
            "RQ": float((1.0 - res.q).mean()),
            "violation": float(res.violation),
            "avg_ttft": float(res.ttft.mean()),
            "avg_tpot": float(res.tpot.mean()),
            "cache_hit_frac": float(res.hit.mean()),
        }
        if self.trace.has_slos:
            n = self.n_valid
            ok = slo_ok(res.ttft, res.tpot, self.tables.ttft_deadline[:n],
                        self.tables.tpot_deadline[:n])
            out["slo_attainment"] = float(ok.to(torch.float32).mean())
        return out

    def per_dataset_quality(self, res: EvalResult) -> dict:
        out = {}
        task = torch.as_tensor(self.trace.task, device=res.q.device)
        for t, name in enumerate(TASKS):
            mask = task == t
            out[name] = float(torch.where(mask, res.q, 0.0).sum()
                              / torch.clamp(mask.sum(), min=1))
        return out
