"""Threshold routing policy — paper Algorithm 2 ("Runtime LLM Request
Routing") plus the threshold genome the NSGA-II optimizes (§IV-B.6).

Genome layout (6 decision variables, all continuous):

    [θ_d_code, θ_d_math, θ_d_general, θ_q, θ_t_code, θ_t_math]

``decide_pair_torch`` decides for a whole population at once (genomes (P, 6),
queue lengths (P, n_nodes)); ``decide_pair_py`` is a line-by-line Python
transcription of Algorithm 2 used as the test oracle. The port of
``repro.core.policies.threshold``.

Category encoding: 0 = 'code', 1 = 'math', 2 = 'general'. Model types:
0 = 'instruct', 1 = 'coder', 2 = 'math', 3 = 'general'.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...cluster.spec import ClusterArrays
from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy

THRESHOLD_NAMES = ("theta_d_code", "theta_d_math", "theta_d_general",
                   "theta_q", "theta_t_code", "theta_t_math")

# search bounds for NSGA-II (θ_d in [0,1], θ_q in [0, 16] requests,
# θ_t in [0.34, 1] — below 1/3 the classifier confidence gate is vacuous)
BOUNDS_LO = np.array([0.0, 0.0, 0.0, 0.0, 0.34, 0.34], np.float32)
BOUNDS_HI = np.array([1.0, 1.0, 1.0, 16.0, 1.0, 1.0], np.float32)

# paper's illustrative defaults (θ_d,general = 0.5, θ_q = 5, θ_t = 0.7)
PAPER_DEFAULTS = np.array([0.5, 0.5, 0.5, 5.0, 0.7, 0.7], np.float32)

CAT_CODE, CAT_MATH, CAT_GENERAL = 0, 1, 2
TYPE_INSTRUCT, TYPE_CODER, TYPE_MATH = 0, 1, 2


def decide_pair_torch(genomes: torch.Tensor, *, complexity: torch.Tensor,
                      pred_category: torch.Tensor, pred_conf: torch.Tensor,
                      queue_len: torch.Tensor, arrays: ClusterArrays
                      ) -> torch.Tensor:
    """Algorithm 2 for P genomes at once. Returns (P,) int64 pair indices.

    Lines reference the paper's pseudo-code:
      5-13: go_edge from per-category difficulty thresholds
      15-17: filter edge nodes by queue (θ_q); none -> cloud fallback
      19-25: model type from classifier confidence gates (θ_t)
      26: first edge node (by node order) hosting the matching model whose
          queue passes; if the chosen type is unavailable on passing nodes,
          fall back to cloud.
    """
    d_code, d_math, d_general, th_q, t_code, t_math = genomes.unbind(dim=1)
    is_code = pred_category == CAT_CODE
    is_math = pred_category == CAT_MATH

    # lines 5-13, elif-chain semantics: a code/math request that fails its
    # own threshold still falls through to the general-threshold check
    go_edge = ((is_code & (complexity < d_code))
               | (is_math & (complexity < d_math))
               | (complexity < d_general))

    sel_type = torch.where(is_code & (pred_conf >= t_code), TYPE_CODER,
                           torch.where(is_math & (pred_conf >= t_math),
                                       TYPE_MATH, TYPE_INSTRUCT))

    # candidate pairs of the selected type, ordered by node index (-1 pad)
    cand = arrays.edge_pairs_by_type[sel_type]                # (P, n_edge)
    cand_node = arrays.pair_node[cand.clamp(min=0).long()]
    cand_q_ok = queue_len.gather(1, cand_node.long()) <= th_q[:, None]
    ok = (cand >= 0) & cand_q_ok
    any_ok = ok.any(dim=1)
    first = ok.to(torch.int32).argmax(dim=1)                  # first True
    fallback = arrays.cloud_fallback_pair
    edge_pair = torch.where(any_ok, cand.gather(1, first[:, None])[:, 0],
                            fallback)
    return torch.where(go_edge, edge_pair, fallback).long()


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decide_pair_py(genome: Sequence[float], *, complexity: float,
                   pred_category: int, pred_conf: float,
                   queue_len: Sequence[int], arrays: ClusterArrays) -> int:
    """Reference transcription of Algorithm 2 (test oracle)."""
    (d_code, d_math, d_general, th_q, t_code, t_math) = \
        [float(x) for x in _np(genome)]
    pair_node = _np(arrays.pair_node)
    edge_by_type = _np(arrays.edge_pairs_by_type)
    fallback = int(_np(arrays.cloud_fallback_pair))
    queue_len = _np(queue_len)

    if pred_category == CAT_CODE and complexity < d_code:
        go_edge = True
    elif pred_category == CAT_MATH and complexity < d_math:
        go_edge = True
    elif complexity < d_general:
        go_edge = True
    else:
        go_edge = False

    if not go_edge:
        return fallback

    if pred_category == CAT_CODE and pred_conf >= t_code:
        sel_type = TYPE_CODER
    elif pred_category == CAT_MATH and pred_conf >= t_math:
        sel_type = TYPE_MATH
    else:
        sel_type = TYPE_INSTRUCT

    for pair in edge_by_type[sel_type]:
        if pair < 0:
            continue
        if queue_len[pair_node[pair]] <= th_q:
            return int(pair)
    return fallback


class ThresholdPolicy(RoutingPolicy):
    """Registered wrapper over the Algorithm-2 decision pair."""

    name = "threshold"
    genome_spec = GenomeSpec(names=THRESHOLD_NAMES, lo=BOUNDS_LO,
                             hi=BOUNDS_HI, defaults=PAPER_DEFAULTS)
    requires = frozenset({"features"})

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        return decide_pair_torch(genomes, complexity=inp.complexity,
                                 pred_category=inp.pred_category,
                                 pred_conf=inp.pred_conf,
                                 queue_len=inp.queue_len, arrays=arrays)

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        return decide_pair_py(genome, complexity=float(inp.complexity),
                              pred_category=int(inp.pred_category),
                              pred_conf=float(inp.pred_conf),
                              queue_len=inp.queue_len, arrays=arrays)


register_policy(ThresholdPolicy())
