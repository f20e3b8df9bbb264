"""Cloud-edge cluster specification (paper §III / §V-C).

A cluster is a set of nodes N = N_cloud ∪ N_edge, a global model set M, and a
deployment map M(n_j) ⊆ M (the paper's model deployment function). The routing
solution space is S = {(n_j, m_k) | m_k ∈ M(n_j)}, enumerated once as a flat
*pair table* so the evaluator indexes decisions by a single integer.

A copy of ``repro.cluster.spec`` with the disaggregated prefill/decode
tables (node roles, KV links, the route table); the fleet testbed waits for
the serving fleet (ROADMAP.md Queue 1 item 11). Every array is built in
numpy exactly as the reference builds it and moved to the device last
(``to_arrays(device)``).

Quality model
-------------
q(r, m) = clip(base[m, task] + slope_m · (0.5 − difficulty_r) + ε(r, m), 0, 1)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .._device import Device, tensors

TASKS = ("mbpp", "gsm8k", "squad", "hellaswag")
MODEL_TYPES = ("instruct", "coder", "math", "general")
MODEL_TYPE_INDEX = {t: i for i, t in enumerate(MODEL_TYPES)}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One LLM in the global model set M (paper §III)."""

    name: str
    model_type: str                 # 'instruct' | 'coder' | 'math' | 'general'
    params_b: float                 # billions of parameters
    price_per_mtok: float           # $ per 1e6 tokens (Together.ai-style)
    base_quality: Tuple[float, float, float, float]  # per TASKS order
    difficulty_slope: float         # quality sensitivity to request difficulty
    verbosity: float = 1.0          # response-length multiplier vs task mean
    kv_bytes_per_token: float = 0.0  # KV-cache footprint; 0 → params_b * 1024

    def __post_init__(self):
        assert self.model_type in MODEL_TYPES
        assert len(self.base_quality) == len(TASKS)

    @property
    def kv_bytes(self) -> float:
        """Bytes of KV cache per prompt token (drives transfer sizing)."""
        return self.kv_bytes_per_token or self.params_b * 1024.0


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Router <-> node link (Eq. 5 terms)."""

    bw_up_bps: float      # router -> node bandwidth B_{r->j}, bytes/s
    bw_down_bps: float    # node -> router bandwidth B_{j->r}, bytes/s
    latency_up_s: float   # latency_{r->j}
    latency_down_s: float  # latency_{j->r}


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One node with its deployed models and serving speeds."""

    name: str
    kind: str                         # 'cloud' | 'edge'
    models: Tuple[str, ...]           # deployment map M(n_j)
    link: LinkSpec
    # serving speed per deployed model (tokens/s), keyed by model name
    prefill_tps: Dict[str, float]
    decode_tps: Dict[str, float]
    concurrency: int = 4              # parallel execution slots (capacity C_j)
    # disaggregated serving: a node may specialize in one phase
    role: str = "unified"             # 'unified' | 'prefill' | 'decode'
    price_factor: float = 1.0         # node price multiplier on model $/Mtok
    # node<->node KV-transfer link (prefill -> decode handoff)
    kv_bw_bps: float = 1e9            # KV link bandwidth, bytes/s
    kv_lat_s: float = 0.002           # per-transfer setup latency, s
    kv_egress_per_gb: float = 0.0     # $ per GB leaving this node

    def __post_init__(self):
        assert self.kind in ("cloud", "edge")
        assert self.role in ("unified", "prefill", "decode"), self.role
        assert self.price_factor > 0 and self.kv_bw_bps > 0
        for m in self.models:
            assert m in self.prefill_tps and m in self.decode_tps, m


class ClusterArrays(NamedTuple):
    """Flat tensor view of the (node, model) pair table for the evaluator."""

    # pairs (n_pairs,)
    pair_node: torch.Tensor           # int32 node index
    pair_model: torch.Tensor          # int32 model index (into global M)
    pair_is_edge: torch.Tensor        # bool
    pair_model_type: torch.Tensor     # int32 into MODEL_TYPES
    pair_price: torch.Tensor          # $ / Mtok
    pair_prefill_tps: torch.Tensor    # float32
    pair_decode_tps: torch.Tensor     # float32
    pair_base_quality: torch.Tensor   # (n_pairs, n_tasks)
    pair_diff_slope: torch.Tensor     # (n_pairs,)
    pair_verbosity: torch.Tensor      # (n_pairs,)
    # nodes (n_nodes,)
    node_is_edge: torch.Tensor
    node_bw_up: torch.Tensor
    node_bw_down: torch.Tensor
    node_lat_up: torch.Tensor
    node_lat_down: torch.Tensor
    node_conc: torch.Tensor           # int32 capacity slots
    # routing helper tables
    # first-edge-pair by model type, ordered by node index: (n_types, n_edge)
    edge_pairs_by_type: torch.Tensor  # int32 pair idx, -1 padded
    cloud_fallback_pair: torch.Tensor  # int32 scalar: high-capacity cloud model
    # disaggregated prefill/decode tables
    node_role: torch.Tensor           # int32: 0 unified, 1 prefill, 2 decode
    kv_lat: torch.Tensor              # (n_nodes, n_nodes) transfer setup, s
    kv_inv_bw: torch.Tensor           # (n_nodes, n_nodes) s/byte, 0 diagonal
    kv_egress: torch.Tensor           # (n_nodes, n_nodes) $/byte, 0 diagonal
    pair_kv_bytes_per_token: torch.Tensor  # (n_pairs,) KV footprint per token
    # route table: every feasible (prefill_pair, decode_pair) combination,
    # same model on both legs; colocated routes (p == q) are included so a
    # tuned policy can *choose* not to disaggregate
    route_prefill: torch.Tensor       # (n_routes,) int32 pair idx
    route_decode: torch.Tensor        # (n_routes,) int32 pair idx

    @property
    def n_pairs(self) -> int:
        return self.pair_node.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.node_is_edge.shape[0]

    @property
    def n_routes(self) -> int:
        return self.route_prefill.shape[0]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    nodes: Tuple[NodeSpec, ...]
    models: Tuple[ModelSpec, ...]

    def model_index(self, name: str) -> int:
        for i, m in enumerate(self.models):
            if m.name == name:
                return i
        raise KeyError(name)

    def pairs(self) -> List[Tuple[int, int]]:
        """Enumerate the solution space S = {(node, model)} (paper §III)."""
        out = []
        for j, node in enumerate(self.nodes):
            for mname in node.models:
                out.append((j, self.model_index(mname)))
        return out

    @property
    def n_pairs(self) -> int:
        return len(self.pairs())

    def describe(self) -> str:
        lines = [f"cluster: {len(self.nodes)} nodes, {len(self.models)} models, "
                 f"{self.n_pairs} routable (node, model) pairs"]
        for j, n in enumerate(self.nodes):
            lines.append(f"  [{j}] {n.name} ({n.kind}, conc={n.concurrency}): "
                         + ", ".join(n.models))
        return "\n".join(lines)

    # -- array views ----------------------------------------------------------
    def arrays_numpy(self) -> Dict[str, np.ndarray]:
        """Every ``ClusterArrays`` field as a numpy array, built as the
        reference's ``to_arrays`` builds it."""
        pairs = self.pairs()
        n_pairs = len(pairs)
        pair_node = np.zeros(n_pairs, np.int32)
        pair_model = np.zeros(n_pairs, np.int32)
        pair_is_edge = np.zeros(n_pairs, bool)
        pair_model_type = np.zeros(n_pairs, np.int32)
        pair_price = np.zeros(n_pairs, np.float32)
        pair_prefill = np.zeros(n_pairs, np.float32)
        pair_decode = np.zeros(n_pairs, np.float32)
        pair_bq = np.zeros((n_pairs, len(TASKS)), np.float32)
        pair_slope = np.zeros(n_pairs, np.float32)
        pair_verb = np.zeros(n_pairs, np.float32)
        pair_kv_bpt = np.zeros(n_pairs, np.float32)
        for p, (j, k) in enumerate(pairs):
            node, model = self.nodes[j], self.models[k]
            pair_node[p] = j
            pair_model[p] = k
            pair_is_edge[p] = node.kind == "edge"
            pair_model_type[p] = MODEL_TYPE_INDEX[model.model_type]
            pair_price[p] = model.price_per_mtok * node.price_factor
            pair_prefill[p] = node.prefill_tps[model.name]
            pair_decode[p] = node.decode_tps[model.name]
            pair_bq[p] = model.base_quality
            pair_slope[p] = model.difficulty_slope
            pair_verb[p] = model.verbosity
            pair_kv_bpt[p] = model.kv_bytes

        n_nodes = len(self.nodes)
        node_is_edge = np.array([n.kind == "edge" for n in self.nodes])
        node_bw_up = np.array([n.link.bw_up_bps for n in self.nodes], np.float32)
        node_bw_down = np.array([n.link.bw_down_bps for n in self.nodes], np.float32)
        node_lat_up = np.array([n.link.latency_up_s for n in self.nodes], np.float32)
        node_lat_down = np.array([n.link.latency_down_s for n in self.nodes], np.float32)
        node_conc = np.array([n.concurrency for n in self.nodes], np.int32)

        # routing helper: per model type, edge pairs ordered by node index
        n_edge = int(node_is_edge.sum())
        edge_by_type = -np.ones((len(MODEL_TYPES), max(n_edge, 1)), np.int32)
        for t in range(len(MODEL_TYPES)):
            col = 0
            for p, (j, k) in enumerate(pairs):
                if pair_is_edge[p] and pair_model_type[p] == t:
                    edge_by_type[t, col] = p
                    col += 1

        # cloud fallback = largest-params model on a cloud node
        cloud_pairs = [(p, self.models[k].params_b)
                       for p, (j, k) in enumerate(pairs)
                       if self.nodes[j].kind == "cloud"]
        assert cloud_pairs, "cluster must contain at least one cloud pair"
        fallback = max(cloud_pairs, key=lambda t: t[1])[0]

        # disaggregated tables: node roles, KV link matrices, route table
        role_ix = {"unified": 0, "prefill": 1, "decode": 2}
        node_role = np.array([role_ix[n.role] for n in self.nodes], np.int32)
        kv_lat = np.zeros((n_nodes, n_nodes), np.float32)
        kv_inv_bw = np.zeros((n_nodes, n_nodes), np.float32)
        kv_egress = np.zeros((n_nodes, n_nodes), np.float32)
        for a, na in enumerate(self.nodes):
            for b, nb in enumerate(self.nodes):
                if a == b:
                    continue
                kv_lat[a, b] = na.kv_lat_s + nb.kv_lat_s
                kv_inv_bw[a, b] = 1.0 / min(na.kv_bw_bps, nb.kv_bw_bps)
                kv_egress[a, b] = na.kv_egress_per_gb / 1e9
        # routes: same model on both legs; prefill leg never on a
        # decode-specialized node, decode leg never on a prefill-specialized
        # node. Colocated (p == q) routes therefore exist exactly on unified
        # nodes, so the route-valued genome can decline to disaggregate.
        route_p, route_q = [], []
        for p, (jp, kp) in enumerate(pairs):
            if node_role[jp] == 2:          # decode-only node can't prefill
                continue
            for q, (jq, kq) in enumerate(pairs):
                if kq != kp or node_role[jq] == 1:   # model mismatch / no decode
                    continue
                route_p.append(p)
                route_q.append(q)
        assert route_p, "cluster must admit at least one (prefill, decode) route"

        return dict(
            pair_node=pair_node, pair_model=pair_model,
            pair_is_edge=pair_is_edge, pair_model_type=pair_model_type,
            pair_price=pair_price, pair_prefill_tps=pair_prefill,
            pair_decode_tps=pair_decode, pair_base_quality=pair_bq,
            pair_diff_slope=pair_slope, pair_verbosity=pair_verb,
            node_is_edge=node_is_edge, node_bw_up=node_bw_up,
            node_bw_down=node_bw_down, node_lat_up=node_lat_up,
            node_lat_down=node_lat_down, node_conc=node_conc,
            edge_pairs_by_type=edge_by_type,
            cloud_fallback_pair=np.asarray(fallback, np.int32),
            node_role=node_role, kv_lat=kv_lat, kv_inv_bw=kv_inv_bw,
            kv_egress=kv_egress, pair_kv_bytes_per_token=pair_kv_bpt,
            route_prefill=np.asarray(route_p, np.int32),
            route_decode=np.asarray(route_q, np.int32))

    def to_arrays(self, device: Device = None) -> ClusterArrays:
        """The pair table as tensors on ``device`` (CUDA unless asked)."""
        return tensors(ClusterArrays, self.arrays_numpy(), device)


# ---------------------------------------------------------------------------
# The paper's testbed (§V-C): 1 cloud node (A40, gemma3:27b) + 3 edge nodes
# (4-core CPU, qwen2.5 1.5b instruct / coder / math).
# ---------------------------------------------------------------------------

def paper_models() -> Tuple[ModelSpec, ...]:
    return (
        ModelSpec(
            name="gemma3:27b", model_type="general", params_b=27.0,
            price_per_mtok=0.83,
            #              mbpp   gsm8k  squad  hellaswag
            base_quality=(0.650, 0.420, 0.905, 0.320),
            difficulty_slope=0.08, verbosity=1.0),
        ModelSpec(
            name="qwen2.5:1.5b-instruct", model_type="instruct", params_b=1.5,
            price_per_mtok=0.0665,
            base_quality=(0.180, 0.140, 0.700, 0.200),
            difficulty_slope=0.45, verbosity=0.9),
        ModelSpec(
            name="qwen2.5-coder:1.5b-instruct", model_type="coder", params_b=1.5,
            price_per_mtok=0.0665,
            base_quality=(0.480, 0.120, 0.450, 0.150),
            difficulty_slope=0.45, verbosity=1.0),
        ModelSpec(
            name="qwen2.5-math:1.5b-instruct", model_type="math", params_b=1.5,
            price_per_mtok=0.0665,
            base_quality=(0.100, 0.330, 0.300, 0.120),
            difficulty_slope=0.45, verbosity=1.1),
    )


def paper_testbed(edge_concurrency: int = 4, cloud_concurrency: int = 8
                  ) -> ClusterSpec:
    """§V-C: 3 edge nodes (4-core CPU, 8GB, no GPU) + 1 cloud node (A40)."""
    models = paper_models()
    edge_models = tuple(m.name for m in models[1:])
    # LAN to edge (fast, near), WAN to cloud (slower, farther)
    edge_link = LinkSpec(bw_up_bps=12.5e6, bw_down_bps=12.5e6,
                         latency_up_s=0.004, latency_down_s=0.004)
    cloud_link = LinkSpec(bw_up_bps=6.25e6, bw_down_bps=6.25e6,
                          latency_up_s=0.035, latency_down_s=0.035)
    # Ollama-style speeds: 27b on A40 GPU vs 1.5b on 4-core CPU
    cloud_speeds_pre = {"gemma3:27b": 2200.0}
    cloud_speeds_dec = {"gemma3:27b": 19.0}
    edge_pre = {m: 300.0 for m in edge_models}
    edge_dec = {m: 5.2 for m in edge_models}
    nodes = (
        NodeSpec(name="cloud-0", kind="cloud", models=("gemma3:27b",),
                 link=cloud_link, prefill_tps=cloud_speeds_pre,
                 decode_tps=cloud_speeds_dec, concurrency=cloud_concurrency),
    ) + tuple(
        NodeSpec(name=f"edge-{i}", kind="edge", models=edge_models,
                 link=edge_link, prefill_tps=dict(edge_pre),
                 decode_tps=dict(edge_dec), concurrency=edge_concurrency)
        for i in range(3)
    )
    return ClusterSpec(nodes=nodes, models=models)


def disagg_testbed(kv_bw_bps: float = 2.5e9,
                   n_decode: int = 2,
                   unified_concurrency: int = 4) -> ClusterSpec:
    """Disaggregated variant of the testbed: one shared cloud model served
    by a prefill-optimized node (batchy compute, weak decode), decode-
    optimized nodes (high decode throughput, poor prefill, cheaper $/Mtok via
    ``price_factor``), and unified nodes that can do both. ``kv_bw_bps``
    parameterizes the prefill->decode KV link.
    """
    model = ModelSpec(
        name="gemma3:27b", model_type="general", params_b=27.0,
        price_per_mtok=0.83,
        base_quality=(0.650, 0.420, 0.905, 0.320),
        difficulty_slope=0.08, verbosity=1.0)
    link = LinkSpec(bw_up_bps=6.25e6, bw_down_bps=6.25e6,
                    latency_up_s=0.020, latency_down_s=0.020)
    name = model.name
    nodes = (
        NodeSpec(name="prefill-0", kind="cloud", models=(name,), link=link,
                 prefill_tps={name: 9000.0}, decode_tps={name: 6.0},
                 concurrency=8, role="prefill", price_factor=0.9,
                 kv_bw_bps=kv_bw_bps, kv_lat_s=0.002),
    ) + tuple(
        NodeSpec(name=f"decode-{i}", kind="cloud", models=(name,), link=link,
                 prefill_tps={name: 250.0}, decode_tps={name: 34.0},
                 concurrency=8, role="decode", price_factor=0.7,
                 kv_bw_bps=kv_bw_bps, kv_lat_s=0.002)
        for i in range(n_decode)
    ) + (
        NodeSpec(name="unified-0", kind="cloud", models=(name,), link=link,
                 prefill_tps={name: 2200.0}, decode_tps={name: 19.0},
                 concurrency=unified_concurrency, role="unified",
                 kv_bw_bps=kv_bw_bps, kv_lat_s=0.002),
        NodeSpec(name="unified-1", kind="cloud", models=(name,), link=link,
                 prefill_tps={name: 2200.0}, decode_tps={name: 19.0},
                 concurrency=unified_concurrency, role="unified",
                 kv_bw_bps=kv_bw_bps, kv_lat_s=0.002),
    )
    return ClusterSpec(nodes=nodes, models=(model,))
