"""Baseline routing strategies (paper §V-C).

Each baseline produces an assignment vector (I,) of pair indices consumed by
the same TraceEvaluator as the NSGA-II policies, so the comparison is
apples-to-apples:

* **Cloud Only** — everything to gemma3:27b on the cloud node.
* **Edge Only** — to an edge model chosen by request type, round-robin over
  edge nodes.
* **Random Router** — uniform over all (node, model) pairs.
* **Round Robin Router** — cycles cloud and edge nodes evenly; model selected
  by request type on edge, the hosted model on cloud.

A numpy copy of ``repro.core.baselines``: the port imports nothing of
``repro``. The assignments are host arrays; the evaluator moves them.
"""
from __future__ import annotations

import numpy as np

from ..cluster.spec import MODEL_TYPE_INDEX, ClusterSpec
from ..workload.trace import Trace

# dataset id (mbpp, gsm8k, squad, hellaswag) -> preferred edge model type
_TASK_TO_TYPE = np.array([MODEL_TYPE_INDEX["coder"], MODEL_TYPE_INDEX["math"],
                          MODEL_TYPE_INDEX["instruct"],
                          MODEL_TYPE_INDEX["instruct"]], np.int32)


def _edge_pair_for(arrays: dict, model_type: int, node_slot: int) -> int:
    row = arrays["edge_pairs_by_type"][model_type]
    row = row[row >= 0]
    assert row.size, f"no edge pair of type {model_type}"
    return int(row[node_slot % row.size])


def cloud_only(trace: Trace, cluster: ClusterSpec) -> np.ndarray:
    arrays = cluster.arrays_numpy()
    return np.full(trace.n_requests, int(arrays["cloud_fallback_pair"]), np.int32)


def edge_only(trace: Trace, cluster: ClusterSpec) -> np.ndarray:
    arrays = cluster.arrays_numpy()
    out = np.zeros(trace.n_requests, np.int32)
    for i in range(trace.n_requests):
        mt = int(_TASK_TO_TYPE[trace.task[i]])
        out[i] = _edge_pair_for(arrays, mt, i)  # round-robin over edge nodes
    return out


def random_router(trace: Trace, cluster: ClusterSpec, seed: int = 0) -> np.ndarray:
    """Uniform tier (cloud/edge) choice, then uniform pair within the tier.

    Note: Table II's Random-Router cost (5.71e-5 $) and RT (2.36 s) sit almost
    exactly halfway between Cloud-Only and Edge-Only, which implies the
    paper's implementation drew the *tier* uniformly (≈50% cloud share) rather
    than sampling the 10 (node, model) pairs uniformly (which would give a 10%
    cloud share and ≈2.7e-5 $). We match the published behaviour.
    """
    arrays = cluster.arrays_numpy()
    rng = np.random.default_rng(seed)
    is_edge = arrays["pair_is_edge"]
    edge_pairs = np.where(is_edge)[0]
    cloud_pairs = np.where(~is_edge)[0]
    to_cloud = rng.random(trace.n_requests) < 0.5
    out = np.where(to_cloud,
                   rng.choice(cloud_pairs, size=trace.n_requests),
                   rng.choice(edge_pairs, size=trace.n_requests))
    return out.astype(np.int32)


def round_robin(trace: Trace, cluster: ClusterSpec) -> np.ndarray:
    """Alternate cloud <-> (next edge node); model by request type on edge.

    "Requests are evenly routed to cloud and edge nodes in a cyclic manner" —
    the published RT (2.4971 s ≈ the exact midpoint of Cloud-Only and
    Edge-Only) confirms a 50/50 cloud/edge split, i.e. the cycle alternates
    between the cloud node and the next edge node, not across the 4 nodes
    uniformly.
    """
    arrays = cluster.arrays_numpy()
    node_is_edge = arrays["node_is_edge"]
    pair_node = arrays["pair_node"]
    pair_type = arrays["pair_model_type"]
    edge_nodes = np.where(node_is_edge)[0]
    cloud_nodes = np.where(~node_is_edge)[0]
    out = np.zeros(trace.n_requests, np.int32)
    e = c = 0
    for i in range(trace.n_requests):
        # flip parity every dataset cycle (period 4) so the 2-cycle here does
        # not systematically pin specific datasets to one tier
        cloud_turn = ((i % 2) ^ ((i // 4) % 2)) == 0
        if cloud_turn:  # cloud turn
            node = int(cloud_nodes[c % cloud_nodes.size])
            c += 1
            cands = np.where(pair_node == node)[0]
            out[i] = int(cands[0])
        else:            # edge turn
            node = int(edge_nodes[e % edge_nodes.size])
            e += 1
            mt = int(_TASK_TO_TYPE[trace.task[i]])
            cands = np.where((pair_node == node) & (pair_type == mt))[0]
            if cands.size == 0:  # node lacks the type: any model it hosts
                cands = np.where(pair_node == node)[0]
            out[i] = int(cands[0])
    return out


def heuristic_bias_init(trace: Trace, cluster: ClusterSpec, pop_size: int,
                        seed: int = 0) -> np.ndarray:
    """Paper §IV-B.1 initial population for the *direct* genome: random with a
    heuristic bias — lightweight requests toward edge, complex toward cloud."""
    arrays = cluster.arrays_numpy()
    rng = np.random.default_rng(seed)
    I = trace.n_requests
    edge_pairs = np.where(arrays["pair_is_edge"])[0]
    cloud_pairs = np.where(~arrays["pair_is_edge"])[0]
    pop = np.zeros((pop_size, I), np.int32)
    p_edge = np.clip(1.0 - trace.complexity, 0.05, 0.95)  # light -> edge
    for p in range(pop_size):
        to_edge = rng.random(I) < p_edge
        pop[p] = np.where(to_edge,
                          rng.choice(edge_pairs, size=I),
                          rng.choice(cloud_pairs, size=I))
    return pop
