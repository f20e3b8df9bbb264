"""Per-category latency SLOs for QoE-aware routing (beyond-paper axis).

The paper collapses latency into one scalar RT (Eq. 4). Production serving
stacks differentiate the two phases of a streamed response:

* **TTFT** (time to first token) — upload + queue wait + prefill; what an
  interactive user perceives as "responsiveness";
* **TPOT** (time per output token) — the decode-phase streaming rate.

A request's QoE contract is the pair of deadlines (TTFT_max, TPOT_max). This
module defines a per-category SLO table plus a deadline-class mix
(interactive vs batch clients), and attaches per-request deadline arrays to a
``Trace``. Deadline heterogeneity is the new scenario axis the SLO-aware
router (``core.policies.slo``) and the attainment objective
(``core.objectives.slo_attainment``) optimize over.

Deadlines are calibrated to the §V-C testbed: cloud decode ≈ 19 tok/s (TPOT
0.053 s) vs edge ≈ 5.2 tok/s (TPOT 0.192 s), so an interactive TPOT budget is
only attainable on the cloud pair while batch budgets admit edge pairs —
exactly the tension phase-split routing has to arbitrate.

A copy of ``repro.workload.slo`` (the port imports nothing of ``repro``); it
must attach the same deadlines bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .classifier import CATEGORIES


@dataclasses.dataclass(frozen=True)
class CategorySLO:
    """Base deadlines (seconds) for one request category."""

    ttft_s: float
    tpot_s: float


# Base per-category contract at tightness 1.0. Code requests tolerate a
# slower first token (editors batch completions) but want fast streaming;
# general chat wants a snappy first token.
DEFAULT_SLO_TABLE: Dict[str, CategorySLO] = {
    "code": CategorySLO(ttft_s=1.40, tpot_s=0.16),
    "math": CategorySLO(ttft_s=1.10, tpot_s=0.14),
    "general": CategorySLO(ttft_s=0.80, tpot_s=0.12),
}

# Deadline classes: interactive clients shrink the budget, batch clients
# relax it enough that edge decode (0.192 s/tok) qualifies.
INTERACTIVE_SCALE = 0.55
BATCH_SCALE = 4.0


def slo_arrays(table: Dict[str, CategorySLO] = DEFAULT_SLO_TABLE
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(n_categories,) base deadline vectors in classifier category order."""
    ttft = np.array([table[c].ttft_s for c in CATEGORIES], np.float32)
    tpot = np.array([table[c].tpot_s for c in CATEGORIES], np.float32)
    return ttft, tpot


def attach_slos(trace, tightness: float = 1.0,
                interactive_frac: float = 0.5, seed: int = 0,
                table: Dict[str, CategorySLO] = DEFAULT_SLO_TABLE):
    """Attach per-request (ttft_deadline, tpot_deadline) arrays to ``trace``.

    Each request draws a deadline class (interactive with probability
    ``interactive_frac``, else batch) and scales its category's base contract
    by the class scale × global ``tightness``. Returns the trace (mutated in
    place) for chaining. Deterministic given ``seed``.
    """
    base_ttft, base_tpot = slo_arrays(table)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 4242]))
    I = trace.n_requests
    interactive = rng.random(I) < interactive_frac
    scale = np.where(interactive, INTERACTIVE_SCALE, BATCH_SCALE)
    scale = scale.astype(np.float32) * np.float32(tightness)
    cat = trace.pred_category
    trace.ttft_deadline = (base_ttft[cat] * scale).astype(np.float32)
    trace.tpot_deadline = (base_tpot[cat] * scale).astype(np.float32)
    trace.slo_interactive = interactive
    return trace
