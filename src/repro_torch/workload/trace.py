"""Mixed-dataset request trace (paper §V-C).

"A test script mixes problems from MBPP, GSM8K, SQuAD, and HellaSwag, sending
500 requests in total with a round-robin order (e.g., MBPP, GSM8K, HellaSwag,
SQuAD, repeating). The requests are evenly distributed across the four
datasets, with 125 requests per dataset."

A copy of ``repro.workload.trace`` (the port imports nothing of ``repro``):
the closed-loop trace, the QoE deadlines of ``workload.slo``, the open-loop
arrival times and workload phases of ``workload.arrivals``, and the session
identity of the multi-turn session trace (``workload.sessions``). It must
build the same trace bit for bit. ``Trace`` is
the array-of-structs view that ``core.fitness.build_tables`` reads;
everything is deterministic given ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

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
    # Optional QoE contract (see workload.slo.attach_slos). None = no SLOs.
    ttft_deadline: Optional[np.ndarray] = None   # (I,) float32 seconds
    tpot_deadline: Optional[np.ndarray] = None   # (I,) float32 s/token
    slo_interactive: Optional[np.ndarray] = None  # (I,) bool deadline class
    # Optional open-loop arrival timestamps (sorted ascending, seconds).
    # None = closed-loop trace.
    arrival_time: Optional[np.ndarray] = None    # (I,) float32
    phase_id: Optional[np.ndarray] = None        # (I,) int32 workload phase
    # Optional multi-turn session identity (workload.sessions): session id
    # (-1 = single-shot), shared-system-prompt class, and the token length of
    # that shared prefix.
    group_id: Optional[np.ndarray] = None        # (I,) int32 session id
    sys_id: Optional[np.ndarray] = None          # (I,) int32 system-prompt id
    sys_tokens: Optional[np.ndarray] = None      # (I,) float32

    @property
    def n_requests(self) -> int:
        return self.task.shape[0]

    @property
    def has_slos(self) -> bool:
        return self.ttft_deadline is not None and self.tpot_deadline is not None

    @property
    def has_arrivals(self) -> bool:
        return self.arrival_time is not None

    @property
    def has_sessions(self) -> bool:
        return self.group_id is not None


def trace_from_requests(reqs: List[ds.Request], seed: int = 0,
                        arrival_time: Optional[np.ndarray] = None) -> Trace:
    """Build the array-of-structs view over an explicit request list, with
    one arrival time per request for an open-loop trace."""
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

    if arrival_time is not None:
        arrival_time = np.asarray(arrival_time, np.float32)
        assert arrival_time.shape == (I,), "one timestamp per request"
        assert (np.diff(arrival_time) >= 0).all(), \
            "open-loop arrival times must be sorted ascending"

    trace = Trace(requests=reqs, task=task, pred_category=pred_cat,
                  pred_conf=pred_conf, complexity=complexity,
                  prompt_tokens=prompt_tokens, resp_tokens_mean=resp_mean,
                  difficulty=difficulty, query_bytes=qbytes,
                  arrival_time=arrival_time)
    # requests of workload.sessions carry session identity; lift it into
    # trace arrays
    if any(r.session_id >= 0 or r.sys_id >= 0 for r in reqs):
        trace.group_id = np.asarray([r.session_id for r in reqs], np.int32)
        trace.sys_id = np.asarray([r.sys_id for r in reqs], np.int32)
        trace.sys_tokens = np.asarray([r.sys_tokens for r in reqs],
                                      np.float32)
    return trace


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
