"""Contextual-bandit routing policy (LinUCB-style explore–exploit).

Built for the learned-estimator loop (``repro_torch.learn``): it scores
every pair by an optimistic reward estimate

    score = (quality + β·unc) − w_rt·RT_est − w_cost·cost_scaled
    RT_est = up + κ·load + prefill + H·tpot          (H = 64-token horizon)

and routes to the argmax. ``quality``/``unc`` are the learned-quality
posterior mean and its uncertainty from the ``PolicyInputs`` quality rows
(the static prior and zeros on static-prior runs — the policy then degrades
to a greedy quality/latency/cost trade-off), and ``prefill``/``tpot`` are
the (possibly learned-corrected) estimate rows. β is the searchable
exploration dimension.

The port of ``repro.core.policies.bandit``: one score tree,
``_bandit_scores``, serves numpy (the oracle and the router) and torch (P
genomes at once, genes as (P, 1) columns), op for op in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

BANDIT_PARAM_NAMES = ("beta", "w_rt", "w_cost", "kappa")

# β exploration bonus per unit uncertainty; w_rt quality-points per second
# of estimated response time; w_cost quality-points per scaled $; κ
# estimated wait seconds per unit node load (the slo/affinity convention).
BANDIT_BOUNDS_LO = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
BANDIT_BOUNDS_HI = np.array([2.0, 2.0, 2.0, 20.0], np.float32)
BANDIT_DEFAULTS = np.array([0.5, 0.5, 0.5, 3.0], np.float32)

_DECODE_HORIZON = np.float32(64.0)   # tokens of decode in the RT estimate
_COST_SCALE = np.float32(100.0)      # per-request $ -> comparable magnitude


def _bandit_scores(beta, w_rt, w_cost, kappa, quality, unc, up, prefill,
                   tpot, cost, load_pair):
    """Shared float32 score tree; ``load_pair`` is each pair's node load."""
    rt_est = (up + kappa * load_pair) + (prefill + _DECODE_HORIZON * tpot)
    return (quality + beta * unc) - (w_rt * rt_est
                                     + w_cost * (cost * _COST_SCALE))


class BanditPolicy(RoutingPolicy):
    """Optimistic (UCB) quality/latency/cost router over learned estimates.

    Stateless as a policy — the exploration state it exercises is the
    shared learned-estimator state (``EvalConfig(learned=True)``); dead
    nodes' DEAD_UP/DEAD_QUEUE sentinels drive their pairs' scores far down.
    """

    name = "bandit"
    genome_spec = GenomeSpec(names=BANDIT_PARAM_NAMES, lo=BANDIT_BOUNDS_LO,
                             hi=BANDIT_BOUNDS_HI, defaults=BANDIT_DEFAULTS)
    requires = frozenset({"features", "estimates", "quality"})

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        load = (inp.queue_len.to(torch.float32)
                / arrays.node_conc.to(torch.float32))
        score = _bandit_scores(
            *(genomes[:, k:k + 1] for k in range(4)), inp.quality, inp.unc,
            inp.up, inp.prefill, inp.tpot, inp.cost,
            load[:, arrays.pair_node.long()])
        return torch.argmax(score, dim=1)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        g = np.asarray(genome, np.float32)
        load = (np.asarray(inp.queue_len).astype(np.float32)
                / np.asarray(arrays.node_conc).astype(np.float32))
        score = _bandit_scores(
            g[0], g[1], g[2], g[3], np.asarray(inp.quality, np.float32),
            np.asarray(inp.unc, np.float32), np.asarray(inp.up, np.float32),
            np.asarray(inp.prefill, np.float32),
            np.asarray(inp.tpot, np.float32),
            np.asarray(inp.cost, np.float32),
            load[np.asarray(arrays.pair_node)])
        return int(np.argmax(score))


register_policy(BanditPolicy())
