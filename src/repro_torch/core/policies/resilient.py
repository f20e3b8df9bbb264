"""Resilience-aware decision policy (chaos extension of the SLO router).

An SLO-style cheapest-feasible rule with a **brownout** term: as cluster
utilization climbs past a searchable threshold ``u_hi``, the effective cost
of non-edge pairs inflates by ``β·brownout``, biasing routing toward cheap
edge pairs exactly when the expensive tier is the scarce resource. Under a
fault regime (crashes masked out via the dead-pair sentinels in
``queue_len``/``up``) the surviving capacity is what saturates, so the
brownout bias is what keeps SLO attainment from collapsing. Genome

    [γ (deadline headroom), κ (est. wait s per unit load),
     β (brownout cost inflation), u_hi (utilization knee)]

The port of ``repro.core.policies.resilient``: ``decide_pair_resilient_torch``
decides for P genomes at once and ``decide_pair_resilient_py`` is the numpy
copy of the reference's oracle. The utilization is a sum over the nodes
taken one node after another in index order in both, the order the
reference's reductions over four nodes take.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...cluster.spec import ClusterArrays
from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

RESILIENT_PARAM_NAMES = ("gamma", "kappa", "beta", "u_hi")

# γ, κ as in the slo policy; β in [0, 4] (cost inflation of non-edge pairs
# at full brownout); u_hi in [0.3, 1.0] (utilization where brownout starts).
RESILIENT_BOUNDS_LO = np.array([0.3, 0.0, 0.0, 0.3], np.float32)
RESILIENT_BOUNDS_HI = np.array([1.1, 20.0, 4.0, 1.0], np.float32)

# hand defaults: slo's (0.9, 3.0) plus a mild brownout past 70% utilization
RESILIENT_DEFAULTS = np.array([0.9, 3.0, 1.0, 0.7], np.float32)

# queue lengths at/above this are the router's dead-node sentinel
# (core.fitness.DEAD_QUEUE) — excluded from the utilization estimate
_DEAD_QUEUE = np.float32(10**6)


def _node_sum(x):
    """Sum over the last (node) axis, one node after another."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def _resilient_scores_np(genome, ttft_deadline, tpot_deadline, up, prefill,
                         tpot, cost, queue_len, node, conc, is_edge):
    """Shared float32 arithmetic for the numpy oracle."""
    gamma = np.float32(genome[0])
    kappa = np.float32(genome[1])
    beta = np.float32(genome[2])
    u_hi = np.float32(genome[3])
    q = queue_len.astype(np.float32)
    alive = q < _DEAD_QUEUE
    load = q / conc.astype(np.float32)
    est_wait = kappa * load[node]
    est_ttft = up + est_wait + prefill
    feasible = (est_ttft <= gamma * ttft_deadline) & \
               (tpot <= np.minimum(gamma, np.float32(1.0)) * tpot_deadline)
    # brownout: mean utilization of the *alive* nodes, clamped to [0, 1],
    # mapped linearly from the u_hi knee to 1.0
    util = np.sum(np.where(alive, np.minimum(load, np.float32(1.0)),
                           np.float32(0.0))) / \
        np.maximum(np.sum(alive.astype(np.float32)), np.float32(1.0))
    brown = np.clip((util - u_hi) / np.maximum(np.float32(1.0) - u_hi,
                                               np.float32(1e-6)),
                    np.float32(0.0), np.float32(1.0))
    eff_cost = cost * (np.float32(1.0) + beta * brown *
                       (np.float32(1.0) - is_edge.astype(np.float32)))
    overshoot = np.maximum(est_ttft / ttft_deadline, tpot / tpot_deadline)
    return feasible, eff_cost, overshoot


def decide_pair_resilient_torch(genomes: torch.Tensor, *,
                                ttft_deadline: torch.Tensor,
                                tpot_deadline: torch.Tensor,
                                up: torch.Tensor, prefill: torch.Tensor,
                                tpot: torch.Tensor, cost: torch.Tensor,
                                queue_len: torch.Tensor,
                                arrays: ClusterArrays) -> torch.Tensor:
    """Cheapest feasible pair by brownout-inflated cost for P genomes (P,
    4); if no pair is feasible, the least worst normalized deadline
    overshoot. Returns (P,) int64."""
    gamma, kappa, beta, u_hi = (genomes[:, k:k + 1] for k in range(4))
    q = queue_len.to(torch.float32)
    alive = q < float(_DEAD_QUEUE)
    load = q / arrays.node_conc.to(torch.float32)             # (P, n_nodes)
    est_wait = kappa * load[:, arrays.pair_node.long()]
    est_ttft = up + est_wait + prefill
    feasible = ((est_ttft <= gamma * ttft_deadline)
                & (tpot <= torch.clamp(gamma, max=1.0) * tpot_deadline))
    util = (_node_sum(torch.where(alive, torch.clamp(load, max=1.0), 0.0))
            / torch.clamp(_node_sum(alive.to(torch.float32)), min=1.0))
    brown = torch.clamp((util[:, None] - u_hi)
                        / torch.clamp(1.0 - u_hi, min=1e-6), 0.0, 1.0)
    is_edge = arrays.pair_is_edge.to(torch.float32)
    eff_cost = cost * (1.0 + beta * brown * (1.0 - is_edge))
    cheapest = torch.argmin(torch.where(feasible, eff_cost, float("inf")),
                            dim=1)
    overshoot = torch.maximum(est_ttft / ttft_deadline, tpot / tpot_deadline)
    least_bad = torch.argmin(overshoot, dim=1)
    return torch.where(feasible.any(dim=1), cheapest, least_bad)


def decide_pair_resilient_py(genome: Sequence[float], *,
                             ttft_deadline: float, tpot_deadline: float,
                             up: np.ndarray, prefill: np.ndarray,
                             tpot: np.ndarray, cost: np.ndarray,
                             queue_len: Sequence[int],
                             arrays: ClusterArrays) -> int:
    """Reference numpy transcription of the resilient decision (oracle)."""
    node = np.asarray(arrays.pair_node)
    conc = np.asarray(arrays.node_conc)
    is_edge = np.asarray(arrays.pair_is_edge)
    feasible, eff_cost, overshoot = _resilient_scores_np(
        np.asarray(genome, np.float32),
        np.float32(ttft_deadline), np.float32(tpot_deadline),
        np.asarray(up, np.float32), np.asarray(prefill, np.float32),
        np.asarray(tpot, np.float32), np.asarray(cost, np.float32),
        np.asarray(queue_len), node, conc, is_edge)
    if feasible.any():
        return int(np.argmin(np.where(feasible, eff_cost, np.inf)))
    return int(np.argmin(overshoot))


class ResilientPolicy(RoutingPolicy):
    """Registered wrapper over the resilient decision pair."""

    name = "resilient"
    genome_spec = GenomeSpec(names=RESILIENT_PARAM_NAMES,
                             lo=RESILIENT_BOUNDS_LO, hi=RESILIENT_BOUNDS_HI,
                             defaults=RESILIENT_DEFAULTS)
    requires = frozenset({"estimates", "deadlines"})

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        return decide_pair_resilient_torch(
            genomes, ttft_deadline=inp.ttft_deadline,
            tpot_deadline=inp.tpot_deadline, up=inp.up, prefill=inp.prefill,
            tpot=inp.tpot, cost=inp.cost, queue_len=inp.queue_len,
            arrays=arrays)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        return decide_pair_resilient_py(
            genome, ttft_deadline=float(inp.ttft_deadline),
            tpot_deadline=float(inp.tpot_deadline), up=inp.up,
            prefill=inp.prefill, tpot=inp.tpot, cost=inp.cost,
            queue_len=inp.queue_len, arrays=arrays)


register_policy(ResilientPolicy())
