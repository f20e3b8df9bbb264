"""Population trace evaluation for NSGA-II fitness (paper §IV-B.2), on tensors.

The evaluator turns a routing decision for every request of the trace into
the three objectives (RQ, C, RT) of Eqs. (2)–(4). Two execution models:

* ``mode="eq5"`` — the paper's Eq. (5) exactly: RT_i = upload + T_infer +
  download, no queueing (what Table II measures at concurrency 1);
* ``mode="queued"`` — closed loop with G concurrent clients and per-node
  execution slots (capacity C_j): requests wait for a free slot, and a wait
  beyond the W_MAX stability bound counts as constraint violation.

The port of ``repro.core.fitness``. Where the reference vmaps a ``lax.scan``
over genomes, the port keeps a leading population dimension P and loops over
the requests in Python: one step advances the queue state of all P genomes
at once, so a population's fitness costs I steps of a few dozen small tensor
ops, whatever P is. Decisions happen inside the loop (they read the live
queue) and go through the policy registry (``core.policies``).

Everything static per (trace × cluster) is precomputed into ``EvalTables``
in numpy with the reference's formulas and types, and moved to the device
last, so the tables are bit-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import Device, resolve, tensors
from ..cluster.spec import TASKS, ClusterArrays, ClusterSpec
from ..workload.trace import Trace
from .policies import PolicyInputs, get_policy

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
    # per-request QoE contract (+inf: the port's traces carry no SLOs yet)
    ttft_deadline: torch.Tensor  # (I,)
    tpot_deadline: torch.Tensor  # (I,)
    prompt_cost: torch.Tensor   # (I, n_pairs) prompt-only part of `cost`
    prompt_tokens: torch.Tensor  # (I,)


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
        ttft_deadline=np.full(I, np.inf, f32),
        tpot_deadline=np.full(I, np.inf, f32),
        prompt_cost=(prompt[:, None] / 1e6 * price[None, :]).astype(f32),
        prompt_tokens=prompt.astype(f32),
    )
    return tables, arrays


def build_tables(trace: Trace, cluster: ClusterSpec, seed: int = 0,
                 device: Device = None) -> Tuple[EvalTables, ClusterArrays]:
    """Precompute all queue-independent quantities on the host, then move
    them to ``device``."""
    tables, arrays = build_tables_numpy(trace, cluster, seed)
    return (tensors(EvalTables, tables, device),
            tensors(ClusterArrays, arrays, device))


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluator configuration. The reference's other execution models keep
    their names here and raise until the port brings them."""

    concurrency: int = 1          # G closed-loop clients
    mode: str = "queued"          # "eq5" | "queued"
    w_max: float = 30.0           # stability bound: wait beyond this = violation
    prefix_cache: bool = False
    disaggregated: bool = False
    faulty: bool = False
    learned: bool = False

    def __post_init__(self):
        wanted = [name for name, on in (
            ("mode='open' (open-loop arrivals)", self.mode == "open"),
            ("prefix_cache", self.prefix_cache),
            ("disaggregated", self.disaggregated),
            ("faulty", self.faulty), ("learned", self.learned)) if on]
        if wanted:
            raise NotImplementedError(
                f"{', '.join(wanted)} is not ported yet: ROADMAP.md Queue 1 "
                f"item 9 brings it")
        assert self.mode in ("eq5", "queued"), self.mode
        assert self.concurrency >= 1

    @property
    def is_eq5(self) -> bool:
        return self.mode == "eq5"


class EvalResult(NamedTuple):
    """Per-request outcomes, (P, I) for a population or (I,) for one run."""

    q: torch.Tensor        # realized quality
    cost: torch.Tensor
    rt: torch.Tensor
    assign: torch.Tensor   # int32 chosen pair
    violation: torch.Tensor  # (P,) or scalar: summed wait beyond w_max
    ttft: torch.Tensor     # time to first token (up + wait + prefill)
    tpot: torch.Tensor     # decode seconds per output token

    def row(self, p: int) -> "EvalResult":
        return EvalResult(*(t[p] for t in self))


def _max_conc(arrays: ClusterArrays) -> int:
    return int(arrays.node_conc.max())


def _run_trace(genomes: torch.Tensor, policy: str, tables: EvalTables,
               arrays: ClusterArrays, cfg: EvalConfig, n_slots: int
               ) -> EvalResult:
    """Route the whole trace for P genomes at once; (P, I) outputs.

    Every row is a real request: the reference's bucketed padding rows and
    the masked means over them come with ``pad_tables`` (not ported)."""
    pol = get_policy(policy)
    dev = genomes.device
    P = genomes.shape[0]
    I = tables.quality.shape[0]
    G = cfg.concurrency
    f32 = torch.float32

    # slot_free[p, n, s] = time when slot s of node n becomes free under
    # genome p; slots beyond a node's concurrency stay at +inf (never chosen)
    slot_valid = (torch.arange(n_slots, device=dev)[None, :]
                  < arrays.node_conc[:, None])
    slot_free = torch.where(slot_valid, 0.0, float("inf")).to(f32)
    slot_free = slot_free.expand(P, -1, -1).clone()
    client_ready = torch.zeros((P, G), dtype=f32, device=dev)
    pstate = torch.as_tensor(pol.init_state(), dtype=f32, device=dev)
    pstate = pstate.expand(P, -1).clone()
    rows = torch.arange(P, device=dev)
    pair_node = arrays.pair_node.long()
    zeros_pairs = torch.zeros_like(tables.tpot)

    q = torch.empty((P, I), dtype=f32, device=dev)
    cost = torch.empty_like(q)
    rt = torch.empty_like(q)
    excess = torch.empty_like(q)
    ttft = torch.empty_like(q)
    tpot = torch.empty_like(q)
    assign = torch.empty((P, I), dtype=torch.int32, device=dev)

    for i in range(I):
        arrival = client_ready[:, i % G]                      # (P,)
        # monitor view: busy slots per node at arrival (the q_j feature)
        busy = (slot_valid & (slot_free > arrival[:, None, None])
                ).sum(dim=2, dtype=torch.int32)               # (P, n_nodes)
        inp = PolicyInputs(
            index=i, now=arrival,
            complexity=tables.complexity[i],
            pred_category=tables.pred_category[i],
            pred_conf=tables.pred_conf[i],
            ttft_deadline=tables.ttft_deadline[i],
            tpot_deadline=tables.tpot_deadline[i],
            prompt_tokens=tables.prompt_tokens[i],
            up=tables.up_time[i], prefill=tables.prefill_time[i],
            tpot=tables.tpot, cost=tables.cost[i],
            prompt_cost=tables.prompt_cost[i], hit_frac=zeros_pairs,
            queue_len=busy, quality=tables.quality_mean[i],
            unc=zeros_pairs)
        pair = pol.decide_torch(genomes, inp, arrays, pstate)  # (P,) int64
        node = pair_node[pair]
        up = tables.up_time[i][pair]
        down = tables.down_time[i][pair]
        service = tables.service[i][pair]
        prefill = tables.prefill_time[i][pair]
        cost_i = tables.cost[i][pair]

        if cfg.is_eq5:
            rt_i = up + service + down                # Eq. (5) verbatim
            completion = arrival + rt_i
            wait = torch.zeros_like(rt_i)
        else:
            ready = arrival + up
            slots_n = slot_free[rows, node]                   # (P, n_slots)
            s = torch.argmin(slots_n, dim=1)                  # first minimum
            free_at = slots_n[rows, s]
            start = torch.maximum(ready, free_at)
            wait = start - ready
            finish = start + service
            completion = finish + down
            rt_i = completion - arrival
            slot_free[rows, node, s] = finish

        client_ready[:, i % G] = completion
        pstate = pol.update_torch(genomes, pstate, inp, pair, cost_i)
        q[:, i] = tables.quality[i][pair]
        cost[:, i] = cost_i
        rt[:, i] = rt_i
        assign[:, i] = pair
        excess[:, i] = torch.clamp(wait - cfg.w_max, min=0.0)
        ttft[:, i] = up + wait + prefill
        tpot[:, i] = tables.tpot[pair]

    return EvalResult(q=q, cost=cost, rt=rt, assign=assign,
                      violation=excess.sum(dim=1), ttft=ttft, tpot=tpot)


def _objectives(res: EvalResult) -> torch.Tensor:
    """(P, 3) means (RQ, C, RT) over the requests."""
    return torch.stack([(1.0 - res.q).mean(dim=1), res.cost.mean(dim=1),
                        res.rt.mean(dim=1)], dim=1)


class TraceEvaluator:
    """Evaluate routing decisions over a fixed (trace × cluster) on
    ``device`` (CUDA unless the caller asks for another)."""

    def __init__(self, trace: Trace, cluster: ClusterSpec,
                 cfg: EvalConfig = EvalConfig(), seed: int = 0,
                 device: Device = None):
        self.device = resolve(device)
        self.trace = trace
        self.cluster = cluster
        self.cfg = cfg
        self.tables, self.arrays = build_tables(trace, cluster, seed=seed,
                                                device=self.device)
        self.n_slots = _max_conc(self.arrays)

    def _genomes(self, policy: str, genomes) -> torch.Tensor:
        spec = get_policy(policy).genome_spec
        dtype = torch.int32 if spec.discrete else torch.float32
        g = torch.as_tensor(genomes).to(device=self.device, dtype=dtype)
        assert g.dim() == 2, "genomes must be (P, D)"
        return g

    # -- runs -----------------------------------------------------------------
    def run_population(self, policy: str, genomes) -> EvalResult:
        """Evaluate P genomes of a registered policy: (P, I) results."""
        return _run_trace(self._genomes(policy, genomes), policy, self.tables,
                          self.arrays, self.cfg, self.n_slots)

    def run_policy(self, policy: str, genome) -> EvalResult:
        """Evaluate one genome of a registered policy: (I,) results."""
        return self.run_population(
            policy, torch.as_tensor(genome)[None]).row(0)

    def run_assignment(self, assign) -> EvalResult:
        return self.run_policy("direct", assign)

    def run_thresholds(self, thresholds) -> EvalResult:
        return self.run_policy("threshold", thresholds)

    # -- population fitness (for NSGA2) --------------------------------------
    def make_fitness(self, genome: str, objectives: str = "paper"):
        """Return a fitness function mapping (P, D) genomes to
        ((P, 3) objectives (RQ, C, RT), (P,) violation)."""
        if objectives != "paper":
            raise NotImplementedError(
                f"objectives={objectives!r} needs SLO deadlines on the trace, "
                f"not ported yet: ROADMAP.md Queue 1 item 9 brings them")
        get_policy(genome)                 # validates the registry name

        def fitness(genomes: torch.Tensor):
            res = self.run_population(genome, genomes)
            return _objectives(res), res.violation

        return fitness

    # -- reporting ------------------------------------------------------------
    def summarize(self, res: EvalResult) -> dict:
        return {
            "avg_quality": float(res.q.mean()),
            "avg_response_time": float(res.rt.mean()),
            "avg_cost": float(res.cost.mean()),
            "RQ": float((1.0 - res.q).mean()),
            "violation": float(res.violation),
            "avg_ttft": float(res.ttft.mean()),
            "avg_tpot": float(res.tpot.mean()),
        }

    def per_dataset_quality(self, res: EvalResult) -> dict:
        out = {}
        task = torch.as_tensor(self.trace.task, device=res.q.device)
        for t, name in enumerate(TASKS):
            mask = task == t
            out[name] = float(torch.where(mask, res.q, 0.0).sum()
                              / torch.clamp(mask.sum(), min=1))
        return out
