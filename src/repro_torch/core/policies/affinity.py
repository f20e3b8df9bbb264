"""Cache-affinity decision policy (prefix-reuse extension).

The SLO decision with a cache-hit-probability term: the expected
cached-prefix fraction per pair discounts both the prefill term of the TTFT
estimate and the prompt part of the cost, and ρ adds an affinity bonus for
pairs already holding the prefix. Genome: [γ, κ, ρ].

The port of ``repro.core.policies.affinity``: ``decide_pair_affinity_torch``
decides for P genomes at once; ``decide_pair_affinity_py`` is the numpy
copy of the reference's oracle. Both keep the reference's f32 arithmetic
op for op (the discount factor ``1 - CACHED_TOKEN_PRICE_FACTOR`` is a
Python double rounded once to f32, as the reference's weak-typed constant
is), so argmin ties break alike.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...cluster.spec import ClusterArrays
from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

AFFINITY_PARAM_NAMES = ("gamma", "kappa", "rho")

# γ, κ as in the SLO genome; ρ in [0, 4] weighs expected prefix-cache hits
# beyond their realized discount (stickiness: a hit now also keeps the
# session's *future* turns cheap on the same node).
AFFINITY_BOUNDS_LO = np.array([0.3, 0.0, 0.0], np.float32)
AFFINITY_BOUNDS_HI = np.array([1.1, 20.0, 4.0], np.float32)
AFFINITY_DEFAULTS = np.array([0.9, 3.0, 1.0], np.float32)

# cached prompt tokens bill at this fraction of the full input price
# (Anthropic/OpenAI-style cached-input discount; vLLM skips the compute)
CACHED_TOKEN_PRICE_FACTOR = 0.1


def decide_pair_affinity_torch(genomes: torch.Tensor, *,
                               ttft_deadline: torch.Tensor,
                               tpot_deadline: torch.Tensor, up: torch.Tensor,
                               prefill: torch.Tensor, tpot: torch.Tensor,
                               cost: torch.Tensor, prompt_cost: torch.Tensor,
                               hit_frac: torch.Tensor,
                               queue_len: torch.Tensor,
                               arrays: ClusterArrays) -> torch.Tensor:
    """Affinity routing for P genomes (P, 3): per-pair rows are (n_pairs,)
    or (P, n_pairs), ``queue_len`` is (P, n_nodes). Returns (P,) int64."""
    gamma, kappa, rho = (genomes[:, k:k + 1] for k in range(3))
    load = (queue_len.to(torch.float32)
            / arrays.node_conc.to(torch.float32))
    est_wait = kappa * load[:, arrays.pair_node.long()]
    prefill_eff = prefill * (1.0 - hit_frac)
    est_ttft = up + est_wait + prefill_eff
    cost_eff = cost - hit_frac * (1.0 - CACHED_TOKEN_PRICE_FACTOR) * prompt_cost
    feasible = ((est_ttft <= gamma * ttft_deadline)
                & (tpot <= torch.clamp(gamma, max=1.0) * tpot_deadline))
    score = cost_eff - rho * hit_frac * prompt_cost
    best = torch.argmin(torch.where(feasible, score, float("inf")), dim=1)
    overshoot = torch.maximum(est_ttft / ttft_deadline, tpot / tpot_deadline)
    least_bad = torch.argmin(overshoot, dim=1)
    return torch.where(feasible.any(dim=1), best, least_bad)


def decide_pair_affinity_py(genome: Sequence[float], *, ttft_deadline: float,
                            tpot_deadline: float, up: np.ndarray,
                            prefill: np.ndarray, tpot: np.ndarray,
                            cost: np.ndarray, prompt_cost: np.ndarray,
                            hit_frac: np.ndarray, queue_len: Sequence[int],
                            arrays: ClusterArrays) -> int:
    """Reference numpy transcription of the affinity decision (test oracle,
    and what the runtime router runs)."""
    g = np.asarray(genome, np.float32)
    gamma, kappa, rho = np.float32(g[0]), np.float32(g[1]), np.float32(g[2])
    node = np.asarray(arrays.pair_node)
    conc = np.asarray(arrays.node_conc)
    up = np.asarray(up, np.float32)
    prefill = np.asarray(prefill, np.float32)
    tpot = np.asarray(tpot, np.float32)
    cost = np.asarray(cost, np.float32)
    prompt_cost = np.asarray(prompt_cost, np.float32)
    hit_frac = np.asarray(hit_frac, np.float32)
    ttft_deadline = np.float32(ttft_deadline)
    tpot_deadline = np.float32(tpot_deadline)

    load = np.asarray(queue_len).astype(np.float32) / conc.astype(np.float32)
    est_wait = kappa * load[node]
    prefill_eff = prefill * (np.float32(1.0) - hit_frac)
    est_ttft = up + est_wait + prefill_eff
    cost_eff = cost - hit_frac * np.float32(
        1.0 - CACHED_TOKEN_PRICE_FACTOR) * prompt_cost
    feasible = (est_ttft <= gamma * ttft_deadline) & \
               (tpot <= np.minimum(gamma, np.float32(1.0)) * tpot_deadline)
    score = cost_eff - rho * hit_frac * prompt_cost
    if feasible.any():
        return int(np.argmin(np.where(feasible, score, np.inf)))
    overshoot = np.maximum(est_ttft / ttft_deadline, tpot / tpot_deadline)
    return int(np.argmin(overshoot))


class AffinityPolicy(RoutingPolicy):
    """Registered wrapper over the cache-affinity decision pair."""

    name = "affinity"
    genome_spec = GenomeSpec(names=AFFINITY_PARAM_NAMES,
                             lo=AFFINITY_BOUNDS_LO, hi=AFFINITY_BOUNDS_HI,
                             defaults=AFFINITY_DEFAULTS)
    requires = frozenset({"estimates", "deadlines", "cache"})

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        return decide_pair_affinity_torch(
            genomes, ttft_deadline=inp.ttft_deadline,
            tpot_deadline=inp.tpot_deadline, up=inp.up, prefill=inp.prefill,
            tpot=inp.tpot, cost=inp.cost, prompt_cost=inp.prompt_cost,
            hit_frac=inp.hit_frac, queue_len=inp.queue_len, arrays=arrays)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        return decide_pair_affinity_py(
            genome, ttft_deadline=float(inp.ttft_deadline),
            tpot_deadline=float(inp.tpot_deadline), up=inp.up,
            prefill=inp.prefill, tpot=inp.tpot, cost=inp.cost,
            prompt_cost=inp.prompt_cost, hit_frac=inp.hit_frac,
            queue_len=inp.queue_len, arrays=arrays)


register_policy(AffinityPolicy())
