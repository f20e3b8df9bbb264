"""Pareto utilities for NSGA-II on tensors.

All functions operate on an objective matrix ``F`` of shape (P, M), P the
population size and M the number of objectives, **minimization** throughout
(the paper minimizes RQ, C, RT — Eq. (1)). The port of ``repro.core.pareto``:
ranks, survival order and tie rules are the reference's exactly.

* ``jnp.lexsort`` is stable; here it is two stable sorts, secondary key
  first (ties in rank and infinite crowding are common, and a non-stable
  sort would change who survives).
* ``jax.ops.segment_min/max`` become ``scatter_reduce`` with
  ``include_self=False``.
* The ``lax.while_loop`` front peel is a Python loop whose stop test reads
  one device value per front.

``dominance_matrix`` is ``kernels.ops.dominance_matrix``: the CUDA kernel for
a CUDA tensor, its plain version for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ops import dominance_matrix

__all__ = [
    "dominance_matrix",
    "non_dominated_sort",
    "crowding_distance",
    "lexsort",
    "pareto_mask",
    "hypervolume_2d",
    "hypervolume_mc",
]

_INT32_MAX = torch.iinfo(torch.int32).max


def pareto_mask(F: torch.Tensor) -> torch.Tensor:
    """(P,) bool mask of non-dominated rows of F."""
    return ~dominance_matrix(F).any(dim=0)


def lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Indices ordering by ``primary`` then ``secondary``, ties by index:
    ``jnp.lexsort((secondary, primary))``."""
    order = torch.sort(secondary, stable=True).indices
    return order[torch.sort(primary[order], stable=True).indices]


def non_dominated_sort(F: torch.Tensor, dom: Optional[torch.Tensor] = None,
                       top: Optional[int] = None) -> torch.Tensor:
    """Return (P,) int32 front ranks (0 = best / non-dominated front).

    Iterative front peeling: repeatedly take the individuals with no
    remaining dominator, give them the current rank, remove them.

    ``dom`` optionally supplies a precomputed (P, P) bool dominance matrix;
    without it the sort computes one with ``dominance_matrix``.

    ``top`` is the survival-selection early exit: peeling stops once at
    least ``top`` individuals are ranked. Every individual beyond the cutoff
    gets the sentinel rank ``P - 1``, so (rank asc, crowd desc) truncation to
    the top ``top`` never selects one; ranks up to the cutoff front equal
    the full sort's.
    """
    P = F.shape[0]
    if dom is None:
        dom = dominance_matrix(F)  # dom[i, j]: i dominates j
    quota = P if top is None else min(int(top), P)

    rank = torch.full((P,), -1, dtype=torch.int32, device=F.device)
    dom_cnt = dom.sum(dim=0, dtype=torch.int32)
    k = 0
    n_ranked = 0
    # each iteration peels at least one individual, so k < P bounds the loop
    while n_ranked < quota and k < P:
        unranked = rank < 0
        front = unranked & (dom_cnt == 0)
        rank = torch.where(front, k, rank)
        # remove this front's dominance contributions
        dec = (dom & front[:, None]).sum(dim=0, dtype=torch.int32)
        dom_cnt = torch.where(unranked, dom_cnt - dec, dom_cnt)
        # peeled individuals get a sentinel count so they never re-enter
        dom_cnt = torch.where(front, _INT32_MAX, dom_cnt)
        k += 1
        n_ranked = int((rank >= 0).sum())   # one device read per front
    # beyond-cutoff individuals -> the sentinel rank
    return torch.where(rank < 0, P - 1, rank).to(torch.int32)


def crowding_distance(F: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Crowding distance per individual, computed within its own front.

    Boundary solutions of each front get +inf. Distances are normalized per
    objective by the front's objective range (NSGA-II, Deb et al. 2002).
    """
    F = F.to(torch.float32)
    P, M = F.shape
    inf = torch.tensor(float("inf"), device=F.device)
    false = torch.zeros((1,), dtype=torch.bool, device=F.device)
    rank_l = rank.long()
    total = None
    for m in range(M):
        f_m = F[:, m]
        # sort by (rank, objective): each front contiguous, in objective order
        order = lexsort(f_m, rank_l)
        f_sorted = f_m[order]
        r_sorted = rank_l[order]
        prev_same = torch.cat([false, r_sorted[1:] == r_sorted[:-1]])
        next_same = torch.cat([r_sorted[:-1] == r_sorted[1:], false])
        f_prev = torch.cat([f_sorted[:1], f_sorted[:-1]])
        f_next = torch.cat([f_sorted[1:], f_sorted[-1:]])
        gap = torch.where(prev_same & next_same, f_next - f_prev, inf)
        # per-front range through segment min/max over rank ids
        fmin = torch.full((P,), float("inf"), device=F.device).scatter_reduce(
            0, r_sorted, f_sorted, "amin", include_self=False)
        fmax = torch.full((P,), float("-inf"), device=F.device).scatter_reduce(
            0, r_sorted, f_sorted, "amax", include_self=False)
        rng = (fmax - fmin)[r_sorted]
        rng = torch.where(rng <= 0, 1.0, rng)
        contrib = torch.where(torch.isinf(gap), inf, gap / rng)
        out = torch.empty_like(f_m)
        out[order] = contrib
        # sum over objectives in order: inf + finite = inf, as desired
        total = out if total is None else total + out
    return total


def hypervolume_2d(F: torch.Tensor, ref_point: torch.Tensor) -> torch.Tensor:
    """Exact hypervolume for M=2 minimization problems w.r.t. ``ref_point``.

    Dominated or out-of-reference points contribute zero.
    """
    Fc = torch.minimum(F, ref_point[None, :])
    order = torch.argsort(Fc[:, 0], stable=True)
    x = Fc[order, 0]
    y = Fc[order, 1]
    # running minimum of y defines the staircase
    y_min = torch.cummin(y, dim=0).values
    x_next = torch.cat([x[1:], ref_point[0:1]])
    width = torch.clamp(x_next - x, min=0.0)
    return torch.sum(width * torch.clamp(ref_point[1] - y_min, min=0.0))


def hypervolume_mc(F: torch.Tensor, ref_point: torch.Tensor,
                   ideal: torch.Tensor, samples: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   n_samples: int = 8192) -> torch.Tensor:
    """Monte-Carlo hypervolume estimate for arbitrary M (minimization).

    Samples uniformly in the [ideal, ref] box and counts the dominated
    fraction. ``samples`` (n, M) in [0, 1) may be given explicitly; otherwise
    ``n_samples`` are drawn from ``generator``.
    """
    M = F.shape[1]
    if samples is None:
        samples = torch.rand((n_samples, M), generator=generator,
                             device=F.device)
    pts = ideal[None, :] + samples * (ref_point - ideal)[None, :]
    # point p is dominated by front member f if f <= p in all objectives
    dominated = torch.any(torch.all(F[None, :, :] <= pts[:, None, :], dim=-1),
                          dim=1)
    box = torch.prod(ref_point - ideal)
    return torch.mean(dominated.to(torch.float32)) * box
