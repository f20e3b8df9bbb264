"""Request feature extraction (paper §IV-B.6, "Feature Extraction").

The router's feature vector f_i = (c_i, t_i, q_j):

* ``c_i`` — complexity score: weighted combination of prompt token length,
  sentence count, task type and presence of output constraints, normalized to
  [0, 1]. Weights are "empirically tuned based on correlations between
  features and inference time" — we tune them on generated training traces
  (see workload/calibration.py) and freeze them here.
* ``t_i`` — task category + confidence, from workload.classifier.
* ``q_j`` — live node queue length, supplied by the monitor at decision time.

A copy of ``repro.workload.features``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np

from .classifier import CATEGORY_INDEX
from .datasets import Request

# feature weights (sum to 1): token_len, sentence_count, task_type, constraint
W_TOKENS = 0.45
W_SENTENCES = 0.25
W_TASK = 0.20
W_CONSTRAINT = 0.10

# normalization caps (p95 of the generated corpora)
TOKENS_CAP = 260.0
SENTENCES_CAP = 12.0

# task-type prior complexity: code/math are heavier per token than QA/MC
_TASK_WEIGHT = {"code": 0.9, "math": 0.8, "general": 0.35}


def complexity_score(req: Request, pred_category: int) -> float:
    """c_i ∈ [0, 1], computed from *observable* prompt features only."""
    cat = list(CATEGORY_INDEX)[pred_category]
    f_tok = min(req.prompt_tokens / TOKENS_CAP, 1.0)
    f_sent = min(req.sentence_count / SENTENCES_CAP, 1.0)
    f_task = _TASK_WEIGHT[cat]
    f_con = 1.0 if req.has_constraint else 0.0
    c = (W_TOKENS * f_tok + W_SENTENCES * f_sent + W_TASK * f_task
         + W_CONSTRAINT * f_con)
    return float(np.clip(c, 0.0, 1.0))
