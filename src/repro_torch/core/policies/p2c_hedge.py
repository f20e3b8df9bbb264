"""Power-of-two-choices routing with hedge-cost awareness.

Classic p2c load balancing (Mitzenmacher) samples two candidate pairs and
sends the request to the better one: near-optimal load spread at O(1)
decision cost, and no herd behaviour because different requests sample
different candidate sets. The "better" criterion is hedge-cost aware: a
loaded node does not just queue — it *doubles spend* with probability
growing in its load (hedged duplicates). A candidate's effective cost is

    cost × (1 + h · min(load, 1))        (h = genome hedge weight)

and among deadline-feasible candidates the lower effective cost wins; with
no feasible candidate, the lower worst-case deadline overshoot wins.

Candidates come from a counter-based uint32 hash of the request index — no
RNG state, identical everywhere. Genome: [γ (deadline headroom), κ (wait
s/load), h (hedge-cost weight)].

The port of ``repro.core.policies.p2c_hedge``. The request index is a host
integer in the port's evaluator loop and in the router, so both twins draw
the candidates with the wrapping Python-int hash ``_mix32_py`` (the
reference's uint32 arithmetic masked to 32 bits); ``decide_torch`` then
compares the two candidates of all P genomes at once.
"""
from __future__ import annotations

import numpy as np
import torch

from ...faults.schedule import _mix32_py
from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

P2C_PARAM_NAMES = ("gamma", "kappa", "hedge_w")
P2C_BOUNDS_LO = np.array([0.3, 0.0, 0.0], np.float32)
P2C_BOUNDS_HI = np.array([1.1, 20.0, 4.0], np.float32)
P2C_DEFAULTS = np.array([0.9, 3.0, 1.0], np.float32)


def candidates(index: int, n_pairs: int):
    """The two candidate pairs of request ``index``."""
    i = int(index)
    return (_mix32_py(2 * i + 1) % n_pairs, _mix32_py(2 * i + 2) % n_pairs)


class P2CHedgePolicy(RoutingPolicy):
    name = "p2c-hedge"
    genome_spec = GenomeSpec(names=P2C_PARAM_NAMES, lo=P2C_BOUNDS_LO,
                             hi=P2C_BOUNDS_HI, defaults=P2C_DEFAULTS)
    requires = frozenset({"estimates", "deadlines"})

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        gamma, kappa, h = (genomes[:, k:k + 1] for k in range(3))
        c1, c2 = candidates(inp.index, inp.up.shape[-1])
        load = (inp.queue_len.to(torch.float32)
                / arrays.node_conc.to(torch.float32))
        pair_load = load[:, arrays.pair_node.long()]          # (P, n_pairs)
        est_ttft = inp.up + kappa * pair_load + inp.prefill
        feasible = ((est_ttft <= gamma * inp.ttft_deadline)
                    & (inp.tpot <= torch.clamp(gamma, max=1.0)
                       * inp.tpot_deadline))
        eff_cost = inp.cost * (1.0 + h * torch.clamp(pair_load, max=1.0))
        overshoot = torch.maximum(est_ttft / inp.ttft_deadline,
                                  inp.tpot / inp.tpot_deadline)
        f1, f2 = feasible[:, c1], feasible[:, c2]
        # both feasible -> cheaper effective cost; one feasible -> it;
        # neither -> smaller overshoot. Ties keep candidate 1.
        pick2 = torch.where(f1 & f2, eff_cost[:, c2] < eff_cost[:, c1],
                            ~f1 & (f2 | (overshoot[:, c2] < overshoot[:, c1])))
        return c1 + pick2.long() * (c2 - c1)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        g = np.asarray(genome, np.float32)
        gamma, kappa, h = np.float32(g[0]), np.float32(g[1]), np.float32(g[2])
        up = np.asarray(inp.up, np.float32)
        prefill = np.asarray(inp.prefill, np.float32)
        tpot = np.asarray(inp.tpot, np.float32)
        cost = np.asarray(inp.cost, np.float32)
        ttft_dl = np.float32(inp.ttft_deadline)
        tpot_dl = np.float32(inp.tpot_deadline)
        c1, c2 = candidates(inp.index, len(up))

        node = np.asarray(arrays.pair_node)
        conc = np.asarray(arrays.node_conc)
        load = np.asarray(inp.queue_len).astype(np.float32) / \
            conc.astype(np.float32)
        pair_load = load[node]
        est_ttft = up + kappa * pair_load + prefill
        feasible = (est_ttft <= gamma * ttft_dl) & \
                   (tpot <= np.minimum(gamma, np.float32(1.0)) * tpot_dl)
        eff_cost = cost * (np.float32(1.0)
                           + h * np.minimum(pair_load, np.float32(1.0)))
        overshoot = np.maximum(est_ttft / ttft_dl, tpot / tpot_dl)

        f1, f2 = bool(feasible[c1]), bool(feasible[c2])
        if f1 and f2:
            pick2 = bool(eff_cost[c2] < eff_cost[c1])
        elif f1:
            pick2 = False
        elif f2:
            pick2 = True
        else:
            pick2 = bool(overshoot[c2] < overshoot[c1])
        return c2 if pick2 else c1


register_policy(P2CHedgePolicy())
