"""SLO-aware decision policy (QoE extension of the paper's router).

Instead of difficulty thresholds it estimates each pair's TTFT (upload +
predicted queue wait + prefill) and TPOT against the request's phase
deadlines and picks the *cheapest feasible* pair — deadline-tight requests
therefore land on low-queue/cloud pairs while relaxed ones ride cheap edge
pairs. Its genome is

    [γ (deadline headroom, <1 = conservative), κ (est. wait s per unit load)]

searchable by the same NSGA-II via ``TraceEvaluator.make_fitness("slo")``.

The port of ``repro.core.policies.slo``: ``decide_pair_slo_torch`` decides
for a whole population at once (genomes (P, 2), queue lengths (P, n_nodes));
``decide_pair_slo_py`` and ``_slo_scores_np`` are numpy copies of the
reference's oracle, which the runtime router runs. Both mirror the
reference's f32 arithmetic op for op, so argmin ties break alike.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...cluster.spec import ClusterArrays
from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

SLO_PARAM_NAMES = ("gamma", "kappa")

# γ in [0.3, 1.1] (fraction of the deadline budget the estimate may use),
# κ in [0, 20] s of predicted wait at full load.
SLO_BOUNDS_LO = np.array([0.3, 0.0], np.float32)
SLO_BOUNDS_HI = np.array([1.1, 20.0], np.float32)

# sensible hand defaults: 10% headroom, ~3 s wait at a saturated node
SLO_DEFAULTS = np.array([0.9, 3.0], np.float32)


def _slo_scores_np(genome, ttft_deadline, tpot_deadline, up, prefill, tpot,
                   queue_len, node, conc):
    """Shared float32 arithmetic for the numpy oracle (mirrors the tensor
    path op-for-op so argmin tie-breaking is identical)."""
    gamma = np.float32(genome[0])
    kappa = np.float32(genome[1])
    load = queue_len.astype(np.float32) / conc.astype(np.float32)
    est_wait = kappa * load[node]
    est_ttft = up + est_wait + prefill
    # γ headroom hedges the *uncertain* TTFT estimate; TPOT is a known
    # constant per pair, so γ > 1 must not admit guaranteed TPOT misses
    feasible = (est_ttft <= gamma * ttft_deadline) & \
               (tpot <= np.minimum(gamma, np.float32(1.0)) * tpot_deadline)
    overshoot = np.maximum(est_ttft / ttft_deadline, tpot / tpot_deadline)
    return feasible, est_ttft, overshoot


def decide_pair_slo_torch(genomes: torch.Tensor, *,
                          ttft_deadline: torch.Tensor,
                          tpot_deadline: torch.Tensor, up: torch.Tensor,
                          prefill: torch.Tensor, tpot: torch.Tensor,
                          cost: torch.Tensor, queue_len: torch.Tensor,
                          arrays: ClusterArrays) -> torch.Tensor:
    """SLO-aware routing for P genomes at once: the cheapest pair whose
    estimated phase times fit the deadline budget scaled by γ; if no pair
    is feasible, the least worst normalized deadline overshoot. Returns
    (P,) int64 pair indices.

    ``up``/``prefill``/``cost`` are this request's (n_pairs,) rows of the
    precomputed tables; ``tpot`` is the per-pair decode time (n_pairs,);
    ``queue_len`` is the (P, n_nodes) busy-slot view, one row per genome.
    """
    gamma = genomes[:, 0:1]                                   # (P, 1)
    kappa = genomes[:, 1:2]
    load = (queue_len.to(torch.float32)
            / arrays.node_conc.to(torch.float32))             # (P, n_nodes)
    est_wait = kappa * load[:, arrays.pair_node.long()]       # (P, n_pairs)
    est_ttft = up + est_wait + prefill
    feasible = ((est_ttft <= gamma * ttft_deadline)
                & (tpot <= torch.clamp(gamma, max=1.0) * tpot_deadline))
    cheapest = torch.argmin(torch.where(feasible, cost, float("inf")), dim=1)
    overshoot = torch.maximum(est_ttft / ttft_deadline, tpot / tpot_deadline)
    least_bad = torch.argmin(overshoot, dim=1)
    return torch.where(feasible.any(dim=1), cheapest, least_bad)


def decide_pair_slo_py(genome: Sequence[float], *, ttft_deadline: float,
                       tpot_deadline: float, up: np.ndarray,
                       prefill: np.ndarray, tpot: np.ndarray,
                       cost: np.ndarray, queue_len: Sequence[int],
                       arrays: ClusterArrays) -> int:
    """Reference numpy transcription of the SLO decision (test oracle)."""
    node = np.asarray(arrays.pair_node)
    conc = np.asarray(arrays.node_conc)
    feasible, est_ttft, overshoot = _slo_scores_np(
        np.asarray(genome, np.float32),
        np.float32(ttft_deadline), np.float32(tpot_deadline),
        np.asarray(up, np.float32), np.asarray(prefill, np.float32),
        np.asarray(tpot, np.float32), np.asarray(queue_len), node, conc)
    if feasible.any():
        return int(np.argmin(np.where(feasible, np.asarray(cost, np.float32),
                                      np.inf)))
    return int(np.argmin(overshoot))


class SLOPolicy(RoutingPolicy):
    """Registered wrapper over the SLO decision pair."""

    name = "slo"
    genome_spec = GenomeSpec(names=SLO_PARAM_NAMES, lo=SLO_BOUNDS_LO,
                             hi=SLO_BOUNDS_HI, defaults=SLO_DEFAULTS)
    requires = frozenset({"estimates", "deadlines"})

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        return decide_pair_slo_torch(
            genomes, ttft_deadline=inp.ttft_deadline,
            tpot_deadline=inp.tpot_deadline, up=inp.up, prefill=inp.prefill,
            tpot=inp.tpot, cost=inp.cost, queue_len=inp.queue_len,
            arrays=arrays)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        return decide_pair_slo_py(genome, ttft_deadline=float(inp.ttft_deadline),
                                  tpot_deadline=float(inp.tpot_deadline),
                                  up=inp.up, prefill=inp.prefill,
                                  tpot=inp.tpot, cost=inp.cost,
                                  queue_len=inp.queue_len, arrays=arrays)


register_policy(SLOPolicy())
