"""Plain PyTorch versions of the port's kernels.

They are the semantic ground truth: the CPU tests run them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. The main
path never calls them on a CUDA tensor.
"""
from __future__ import annotations

import torch


def dominance_matrix(F: torch.Tensor) -> torch.Tensor:
    """(P, M) objectives -> (P, P) bool, D[i, j] = i dominates j (minimize).

    Compared in f32 whatever the input type."""
    F = F.to(torch.float32)
    le = torch.all(F[:, None, :] <= F[None, :, :], dim=-1)
    lt = torch.any(F[:, None, :] < F[None, :, :], dim=-1)
    return le & lt


def dominance_counts(F: torch.Tensor) -> torch.Tensor:
    """(P,) int32: number of individuals dominating each column j."""
    return dominance_matrix(F).sum(dim=0, dtype=torch.int32)
