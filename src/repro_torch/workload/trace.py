"""Mixed-dataset request trace (paper §V-C).

"A test script mixes problems from MBPP, GSM8K, SQuAD, and HellaSwag, sending
500 requests in total with a round-robin order (e.g., MBPP, GSM8K, HellaSwag,
SQuAD, repeating). The requests are evenly distributed across the four
datasets, with 125 requests per dataset."

A copy of ``repro.workload.trace`` pruned to the closed-loop trace the port
evaluates: no SLO deadlines, arrival times or session identity yet. It must
build the same trace bit for bit. ``Trace`` is the array-of-structs view that
``core.fitness.build_tables`` reads; everything is deterministic given
``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import datasets as ds
from .classifier import classify
from .features import complexity_score

# round-robin order used by the paper's test script
ORDER = ("mbpp", "gsm8k", "hellaswag", "squad")


@dataclasses.dataclass
class Trace:
    """I requests with observable features + latent difficulty (numpy)."""

    requests: List[ds.Request]
    task: np.ndarray            # (I,) int32 dataset id (ds.DATASETS order)
    pred_category: np.ndarray   # (I,) int32 into classifier.CATEGORIES
    pred_conf: np.ndarray       # (I,) float32
    complexity: np.ndarray      # (I,) float32 — c_i
    prompt_tokens: np.ndarray   # (I,) int32
    resp_tokens_mean: np.ndarray  # (I,) float32
    difficulty: np.ndarray      # (I,) float32 latent
    query_bytes: np.ndarray     # (I,) float32

    @property
    def n_requests(self) -> int:
        return self.task.shape[0]


def trace_from_requests(reqs: List[ds.Request], seed: int = 0) -> Trace:
    """Build the array-of-structs view over an explicit request list."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1234]))
    I = len(reqs)
    task = np.zeros(I, np.int32)
    pred_cat = np.zeros(I, np.int32)
    pred_conf = np.zeros(I, np.float32)
    complexity = np.zeros(I, np.float32)
    prompt_tokens = np.zeros(I, np.int32)
    resp_mean = np.zeros(I, np.float32)
    difficulty = np.zeros(I, np.float32)
    qbytes = np.zeros(I, np.float32)
    for i, r in enumerate(reqs):
        task[i] = r.task_id
        pc, conf = classify(r, rng)
        pred_cat[i] = pc
        pred_conf[i] = conf
        complexity[i] = complexity_score(r, pc)
        prompt_tokens[i] = r.prompt_tokens
        resp_mean[i] = r.resp_tokens_mean
        difficulty[i] = r.difficulty
        qbytes[i] = r.query_bytes
    return Trace(requests=reqs, task=task, pred_category=pred_cat,
                 pred_conf=pred_conf, complexity=complexity,
                 prompt_tokens=prompt_tokens, resp_tokens_mean=resp_mean,
                 difficulty=difficulty, query_bytes=qbytes)


def build_trace(n_requests: int = 500, seed: int = 0) -> Trace:
    per = (n_requests + len(ORDER) - 1) // len(ORDER)
    pools = {name: ds.generate(name, per, seed=seed) for name in ORDER}
    cursors = {name: 0 for name in ORDER}

    reqs: List[ds.Request] = []
    for i in range(n_requests):
        name = ORDER[i % len(ORDER)]
        reqs.append(pools[name][cursors[name]])
        cursors[name] += 1
    return trace_from_requests(reqs, seed=seed)
