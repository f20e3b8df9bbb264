"""The routing reference: the paper's Algorithm 2 under a threshold genome
over the testbed of a configuration file, with the router's simulated
task classifier and complexity score, frozen.

The classifier draws its noise from one ``numpy`` stream seeded 0 for the
server's life, one draw of three normals per routed request in the order
the requests are routed, as the server's router does. A node's queue
length at each decision is the count of requests routed to it and not yet
finished, as the harness keeps it from its own record of the run, not
the server's state: the reference decides from those counts and from the
request alone.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

CATEGORIES = ("code", "math", "general")
TYPES = ("instruct", "coder", "math", "general")
_CODE_KEYS = ("python", "function", "assert", "code", "return")
_MATH_KEYS = ("how many", "dollars", "left?", "friends", "each")
# complexity score: weights of token length, sentence count, task type and
# output constraint; normalization caps; task-type priors
W_TOKENS, W_SENTENCES, W_TASK, W_CONSTRAINT = 0.45, 0.25, 0.20, 0.10
TOKENS_CAP, SENTENCES_CAP = 260.0, 12.0
TASK_WEIGHT = (0.9, 0.8, 0.35)


def classify(req, rng: np.random.Generator) -> Tuple[int, float]:
    t = req.text.lower()
    code = sum(k in t for k in _CODE_KEYS) / len(_CODE_KEYS)
    math_ = sum(k in t for k in _MATH_KEYS) / len(_MATH_KEYS)
    gen = 0.35 + 0.1 * ("context:" in t or "scenario" in t)
    logits = np.array([code * 2.2, math_ * 2.2, gen * 2.0])
    logits = logits + rng.normal(0.0, 0.18, size=3)
    e = np.exp(logits - logits.max())
    p = e / e.sum()
    pred = int(np.argmax(p))
    return pred, float(p[pred])


def complexity(req, category: int) -> float:
    c = (W_TOKENS * min(req.prompt_tokens / TOKENS_CAP, 1.0)
         + W_SENTENCES * min(req.sentence_count / SENTENCES_CAP, 1.0)
         + W_TASK * TASK_WEIGHT[category]
         + W_CONSTRAINT * (1.0 if req.has_constraint else 0.0))
    return float(np.clip(c, 0.0, 1.0))


class Testbed:
    """The (node, model) pairs of a configuration's ``testbed`` group, in
    node order then model order."""

    def __init__(self, tb: dict):
        self.pairs: List[Tuple[int, str]] = [
            (j, name) for j, node in enumerate(tb["nodes"])
            for name in node["models"]]
        kinds = [node["kind"] for node in tb["nodes"]]
        self.pair_node = [j for j, _ in self.pairs]
        self.pair_edge = [kinds[j] == "edge" for j, _ in self.pairs]
        self.served_by = [tb["served_by"][name] for _, name in self.pairs]
        types = [TYPES.index(tb["model_types"][name]) for _, name in self.pairs]
        self.edge_by_type = [[p for p in range(len(self.pairs))
                              if self.pair_edge[p] and types[p] == t]
                             for t in range(len(TYPES))]
        self.fallback = next(p for p in range(len(self.pairs))
                             if not self.pair_edge[p])
        self.thresholds = [float(np.float32(x)) for x in tb["thresholds"]]


def decide(tb: Testbed, req, queue: Sequence[int],
           rng: np.random.Generator) -> int:
    """Algorithm 2: the pair that a request goes to."""
    cat, conf = classify(req, rng)
    # the router hands the policy float32 features and genome
    c = float(np.float32(complexity(req, cat)))
    conf = float(np.float32(conf))
    d_code, d_math, d_general, th_q, t_code, t_math = tb.thresholds
    go_edge = ((cat == 0 and c < d_code) or (cat == 1 and c < d_math)
               or c < d_general)
    if not go_edge:
        return tb.fallback
    sel = 1 if cat == 0 and conf >= t_code else \
        2 if cat == 1 and conf >= t_math else 0
    for p in tb.edge_by_type[sel]:
        if queue[tb.pair_node[p]] <= th_q:
            return p
    return tb.fallback
