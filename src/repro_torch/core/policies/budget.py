"""Budget-capped routing: hard per-window cost cap with cheapest-feasible
fallback.

Production routers run under spend governance: a tenant's traffic must not
exceed a dollar budget per accounting window no matter what the deadline
structure wants. This policy keeps a per-window spend ledger in its state
and routes in three tiers:

1. while the window has budget, behave like the SLO policy *restricted to
   pairs the remaining budget can still afford* (cheapest deadline-feasible
   affordable pair);
2. if no affordable pair is deadline-feasible, sacrifice latency: cheapest
   affordable pair;
3. if the ledger is exhausted (nothing affordable), hard-cap mode: the
   globally cheapest pair.

The ledger is the policy's state ``[window_id, spent]`` (``state_size`` 2),
one row per genome in the evaluator. Spend is billed at **list price from
the shared float32 cost table** (not the realized cache-discounted cost),
so every implementation accumulates bit-identical float32 ledgers.

Genome: [B (window budget, $), γ (deadline headroom), κ (wait s/load)].

The port of ``repro.core.policies.budget``: ``decide_torch``/``update_torch``
run the decision and the ledger for P genomes at once (state (P, 2));
``decide_py``/``update_py`` are the numpy copies the router runs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

BUDGET_PARAM_NAMES = ("window_budget", "gamma", "kappa")
BUDGET_BOUNDS_LO = np.array([0.001, 0.3, 0.0], np.float32)
BUDGET_BOUNDS_HI = np.array([0.05, 1.1, 20.0], np.float32)
BUDGET_DEFAULTS = np.array([0.01, 0.9, 3.0], np.float32)

#: Accounting window length in trace seconds. The runtime router defaults
#: ``now`` to its request counter (a window is then WINDOW_S consecutive
#: requests); callers that re-fit this policy on recorded arrival
#: timestamps must pass the same clock to ``route(now=)``.
WINDOW_S = 30.0


class BudgetPolicy(RoutingPolicy):
    name = "budget"
    genome_spec = GenomeSpec(names=BUDGET_PARAM_NAMES, lo=BUDGET_BOUNDS_LO,
                             hi=BUDGET_BOUNDS_HI, defaults=BUDGET_DEFAULTS)
    requires = frozenset({"estimates", "deadlines"})
    state_size = 2                      # [window_id, spent_this_window]

    def init_state(self) -> np.ndarray:
        return np.array([-1.0, 0.0], np.float32)

    # -- shared window arithmetic (float32 in both twins) ---------------------
    @staticmethod
    def _window_spent_torch(state, now):
        w = torch.floor(now / WINDOW_S)
        spent = torch.where(w == state[:, 0], state[:, 1], 0.0)
        return w, spent

    @staticmethod
    def _window_spent_py(state, now):
        w = np.float32(np.floor(np.float32(now) / np.float32(WINDOW_S)))
        spent = state[1] if w == state[0] else np.float32(0.0)
        return w, np.float32(spent)

    # -- decisions ------------------------------------------------------------
    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        B, gamma, kappa = (genomes[:, k:k + 1] for k in range(3))
        _, spent = self._window_spent_torch(state, inp.now)
        remaining = torch.clamp(B - spent[:, None], min=0.0)     # (P, 1)

        load = (inp.queue_len.to(torch.float32)
                / arrays.node_conc.to(torch.float32))
        est_ttft = inp.up + kappa * load[:, arrays.pair_node.long()] \
            + inp.prefill
        feas_dl = ((est_ttft <= gamma * inp.ttft_deadline)
                   & (inp.tpot <= torch.clamp(gamma, max=1.0)
                      * inp.tpot_deadline))
        cost = inp.cost.expand_as(feas_dl)
        affordable = cost <= remaining
        feas = feas_dl & affordable

        inf = float("inf")
        cheapest_feas = torch.argmin(torch.where(feas, cost, inf), dim=1)
        cheapest_afford = torch.argmin(torch.where(affordable, cost, inf),
                                       dim=1)
        cheapest = torch.argmin(cost, dim=1)
        return torch.where(feas.any(dim=1), cheapest_feas,
                           torch.where(affordable.any(dim=1),
                                       cheapest_afford, cheapest))

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        g = np.asarray(genome, np.float32)
        B, gamma, kappa = np.float32(g[0]), np.float32(g[1]), np.float32(g[2])
        _, spent = self._window_spent_py(state, inp.now)
        remaining = np.maximum(B - spent, np.float32(0.0))

        up = np.asarray(inp.up, np.float32)
        prefill = np.asarray(inp.prefill, np.float32)
        tpot = np.asarray(inp.tpot, np.float32)
        cost = np.asarray(inp.cost, np.float32)
        node = np.asarray(arrays.pair_node)
        conc = np.asarray(arrays.node_conc)
        load = np.asarray(inp.queue_len).astype(np.float32) / \
            conc.astype(np.float32)
        est_ttft = up + kappa * load[node] + prefill
        feas_dl = (est_ttft <= gamma * np.float32(inp.ttft_deadline)) & \
                  (tpot <= np.minimum(gamma, np.float32(1.0))
                   * np.float32(inp.tpot_deadline))
        affordable = cost <= remaining
        feas = feas_dl & affordable
        if feas.any():
            return int(np.argmin(np.where(feas, cost, np.inf)))
        if affordable.any():
            return int(np.argmin(np.where(affordable, cost, np.inf)))
        return int(np.argmin(cost))

    # -- ledger updates -------------------------------------------------------
    def update_torch(self, genomes, state, inp: PolicyInputs, pair, cost):
        # bill at list price from the shared f32 table (see module docstring)
        w, spent = self._window_spent_torch(state, inp.now)
        return torch.stack([w, spent + inp.cost[pair]], dim=1)

    def update_py(self, genome, state, inp: PolicyInputs, pair: int,
                  cost: float) -> np.ndarray:
        w, spent = self._window_spent_py(state, inp.now)
        billed = np.float32(np.asarray(inp.cost, np.float32)[pair])
        return np.array([w, spent + billed], np.float32)


register_policy(BudgetPolicy())
