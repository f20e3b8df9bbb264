"""Objective metrics (paper Eqs. 2–5), the §V-D composite score, and the
QoE/SLO objectives, on tensors.

All metrics are computed from per-request vectors produced by the evaluator:
``q`` (quality score in [0,1]), ``cost`` ($ per request), ``rt`` (seconds);
``ttft`` and ``tpot`` split ``rt`` into its serving phases. The port of
``repro.core.objectives``; ``overall_scores`` is a numpy copy.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Objectives(NamedTuple):
    RQ: torch.Tensor   # Eq. 2: mean(1 - q)  (minimize)
    C: torch.Tensor    # Eq. 3: mean cost    (minimize)
    RT: torch.Tensor   # Eq. 4: mean latency (minimize)

    def stack(self) -> torch.Tensor:
        return torch.stack([self.RQ, self.C, self.RT])


def aggregate(q: torch.Tensor, cost: torch.Tensor, rt: torch.Tensor
              ) -> Objectives:
    return Objectives(RQ=torch.mean(1.0 - q), C=torch.mean(cost),
                      RT=torch.mean(rt))


def weighted_scalar(obj: Objectives, weights: Sequence[float],
                    norm_lo: Sequence[float], norm_hi: Sequence[float]
                    ) -> torch.Tensor:
    """Paper Eq. (1): min ω1·RQ + ω2·C + ω3·RT over min-max normalized terms."""
    f = obj.stack()
    lo = torch.as_tensor(norm_lo, dtype=f.dtype, device=f.device)
    hi = torch.as_tensor(norm_hi, dtype=f.dtype, device=f.device)
    fn = (f - lo) / torch.where(hi - lo <= 0, 1.0, hi - lo)
    return torch.dot(torch.as_tensor(weights, dtype=f.dtype, device=f.device),
                     fn)


class QoEObjectives(NamedTuple):
    """Paper objectives + SLO violation rate (all minimized)."""

    RQ: torch.Tensor
    C: torch.Tensor
    RT: torch.Tensor
    V: torch.Tensor    # 1 - SLO attainment (fraction missing a deadline)

    def stack(self) -> torch.Tensor:
        return torch.stack([self.RQ, self.C, self.RT, self.V])


def slo_ok(ttft: torch.Tensor, tpot: torch.Tensor,
           ttft_deadline: torch.Tensor, tpot_deadline: torch.Tensor
           ) -> torch.Tensor:
    """(I,) bool — request met BOTH phase deadlines."""
    return (ttft <= ttft_deadline) & (tpot <= tpot_deadline)


def slo_attainment(ttft: torch.Tensor, tpot: torch.Tensor,
                   ttft_deadline: torch.Tensor, tpot_deadline: torch.Tensor
                   ) -> torch.Tensor:
    """Fraction of requests meeting both TTFT and TPOT deadlines."""
    return torch.mean(slo_ok(ttft, tpot, ttft_deadline, tpot_deadline)
                      .to(torch.float32))


def aggregate_qoe(q: torch.Tensor, cost: torch.Tensor, rt: torch.Tensor,
                  ttft: torch.Tensor, tpot: torch.Tensor,
                  ttft_deadline: torch.Tensor, tpot_deadline: torch.Tensor
                  ) -> QoEObjectives:
    att = slo_attainment(ttft, tpot, ttft_deadline, tpot_deadline)
    return QoEObjectives(RQ=torch.mean(1.0 - q), C=torch.mean(cost),
                         RT=torch.mean(rt), V=1.0 - att)


def overall_scores(avg_quality: np.ndarray, avg_rt: np.ndarray,
                   avg_cost: np.ndarray) -> np.ndarray:
    """§V-D composite: min-max normalize each dimension across the compared
    strategies (larger = better), then average the three normalized scores."""
    q, t, c = map(np.asarray, (avg_quality, avg_rt, avg_cost))

    def _norm(x, larger_better):
        rng = x.max() - x.min()
        if rng <= 0:
            return np.ones_like(x)
        return (x - x.min()) / rng if larger_better else (x.max() - x) / rng

    return (_norm(q, True) + _norm(t, False) + _norm(c, False)) / 3.0
