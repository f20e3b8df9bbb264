"""Disaggregated (prefill, decode) routing policy.

The paper routes each request to a single (node, model) pair; this policy
routes over the cluster's *route table* instead — every feasible
``(prefill_pair, decode_pair)`` combination from
``ClusterArrays.route_prefill/route_decode``, including colocated routes
(prefill_pair == decode_pair) on unified nodes. NSGA-II therefore discovers
*when* disaggregation wins: with a fast KV link and long prompts the tuned
genome splits phases across prefill-/decode-optimized nodes; when the
transfer cost dominates it collapses onto colocated routes.

Genome: [γ (deadline headroom on the TTFT estimate), κ (estimated queue
wait, s per unit load), τ (latency price, $ per second of est. TTFT + KV
transfer)].

The decision scores each route by its *realized* dollar cost — prompt side
billed on the prefill pair (with the cache discount), decode side on the
decode pair, plus KV egress for split routes — and a τ-weighted latency
term that includes the KV-transfer time ``kv_bytes × 1/bw + setup``. Among
deadline-feasible routes the cheapest score wins; with none feasible it
minimizes the worst normalized deadline overshoot, like the SLO policy.

The port of ``repro.core.policies.disagg``: ``decide_route_disagg_torch``
scores the routes of P genomes at once, ``decide_route_disagg_py`` is the
numpy copy of the reference's oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from . import register_policy
from .affinity import CACHED_TOKEN_PRICE_FACTOR
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

DISAGG_PARAM_NAMES = ("gamma", "kappa", "tau")
DISAGG_BOUNDS_LO = np.array([0.3, 0.0, 0.0], np.float32)
DISAGG_BOUNDS_HI = np.array([1.1, 20.0, 1.0], np.float32)
DISAGG_DEFAULTS = np.array([0.9, 3.0, 1e-3], np.float32)

# the reference's jnp.float32(1.0 - C): the double difference rounded once
_DISCOUNT = float(np.float32(1.0 - CACHED_TOKEN_PRICE_FACTOR))


def decide_route_disagg_torch(genomes: torch.Tensor, inp: PolicyInputs,
                              arrays) -> torch.Tensor:
    """Route-table scoring for P genomes (P, 3); returns (P,) int64 route
    indices."""
    gamma, kappa, tau = (genomes[:, k:k + 1] for k in range(3))
    p = arrays.route_prefill.long()
    q = arrays.route_decode.long()
    pair_node = arrays.pair_node.long()
    node_p, node_q = pair_node[p], pair_node[q]
    load = (inp.queue_len.to(torch.float32)
            / arrays.node_conc.to(torch.float32))             # (P, n_nodes)
    hit = inp.hit_frac[..., p]
    kv_bytes = torch.as_tensor(inp.kv_bytes, device=genomes.device
                               ).expand(inp.up.shape[-1:])
    est_ttft = inp.up[..., p] + kappa * load[:, node_p] \
        + inp.prefill[..., p] * (1.0 - hit)
    tt = arrays.kv_lat[node_p, node_q] + \
        kv_bytes[p] * arrays.kv_inv_bw[node_p, node_q]
    feasible = ((est_ttft <= gamma * inp.ttft_deadline)
                & (inp.tpot[..., q] <= torch.clamp(gamma, max=1.0)
                   * inp.tpot_deadline))
    discount = 1.0 - hit * _DISCOUNT
    cost_r = inp.prompt_cost[..., p] * discount + \
        (inp.cost[..., q] - inp.prompt_cost[..., q]) + \
        kv_bytes[p] * arrays.kv_egress[node_p, node_q]
    score = cost_r + tau * (est_ttft + tt + kappa * load[:, node_q])
    cheapest = torch.argmin(torch.where(feasible, score, float("inf")), dim=1)
    overshoot = torch.maximum((est_ttft + tt) / inp.ttft_deadline,
                              inp.tpot[..., q] / inp.tpot_deadline)
    least_bad = torch.argmin(overshoot, dim=1)
    return torch.where(feasible.any(dim=1), cheapest, least_bad)


def decide_route_disagg_py(genome, inp: PolicyInputs, arrays) -> int:
    """Numpy transcription, op-for-op in float32 (test oracle / runtime)."""
    g = np.asarray(genome, np.float32)
    gamma, kappa, tau = g[0], g[1], g[2]
    p = np.asarray(arrays.route_prefill)
    q = np.asarray(arrays.route_decode)
    node_p = np.asarray(arrays.pair_node)[p]
    node_q = np.asarray(arrays.pair_node)[q]
    load = np.asarray(inp.queue_len).astype(np.float32) / \
        np.asarray(arrays.node_conc).astype(np.float32)
    up = np.asarray(inp.up, np.float32)
    prefill = np.asarray(inp.prefill, np.float32)
    tpot = np.asarray(inp.tpot, np.float32)
    cost = np.asarray(inp.cost, np.float32)
    prompt_cost = np.asarray(inp.prompt_cost, np.float32)
    kv_bytes = np.broadcast_to(
        np.asarray(inp.kv_bytes, np.float32), up.shape)
    hit = np.asarray(inp.hit_frac, np.float32)[p]
    kv_lat = np.asarray(arrays.kv_lat, np.float32)
    kv_inv_bw = np.asarray(arrays.kv_inv_bw, np.float32)
    kv_egress = np.asarray(arrays.kv_egress, np.float32)
    ttft_dl = np.float32(inp.ttft_deadline)
    tpot_dl = np.float32(inp.tpot_deadline)

    est_ttft = up[p] + kappa * load[node_p] + \
        prefill[p] * (np.float32(1.0) - hit)
    tt = kv_lat[node_p, node_q] + kv_bytes[p] * kv_inv_bw[node_p, node_q]
    feasible = (est_ttft <= gamma * ttft_dl) & \
               (tpot[q] <= np.minimum(gamma, np.float32(1.0)) * tpot_dl)
    discount = np.float32(1.0) - hit * \
        np.float32(1.0 - CACHED_TOKEN_PRICE_FACTOR)
    cost_r = prompt_cost[p] * discount + (cost[q] - prompt_cost[q]) + \
        kv_bytes[p] * kv_egress[node_p, node_q]
    score = cost_r + tau * (est_ttft + tt + kappa * load[node_q])
    if feasible.any():
        return int(np.argmin(np.where(feasible, score, np.inf)))
    overshoot = np.maximum((est_ttft + tt) / ttft_dl, tpot[q] / tpot_dl)
    return int(np.argmin(overshoot))


class DisaggPolicy(RoutingPolicy):
    """Registered route-valued policy for disaggregated prefill/decode."""

    name = "disagg"
    genome_spec = GenomeSpec(names=DISAGG_PARAM_NAMES, lo=DISAGG_BOUNDS_LO,
                             hi=DISAGG_BOUNDS_HI, defaults=DISAGG_DEFAULTS)
    requires = frozenset({"estimates", "deadlines", "cache", "transfer"})
    decides = "route"

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        return decide_route_disagg_torch(genomes, inp, arrays)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        return decide_route_disagg_py(genome, inp, arrays)


register_policy(DisaggPolicy())
