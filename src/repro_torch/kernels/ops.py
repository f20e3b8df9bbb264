"""Kernel entry points, dispatched by the device of the input tensor.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``); a CUDA
tensor goes to the hand-written kernel, which launches or raises. There is no
fallback from one to the other and no mode that hides which path ran.
"""
from __future__ import annotations

import torch

from . import dominance as _dom
from . import ref


def dominance_matrix(F: torch.Tensor) -> torch.Tensor:
    """(P, M) -> (P, P) bool Pareto dominance matrix (minimization)."""
    if F.device.type == "cpu":
        return ref.dominance_matrix(F)
    if F.device.type == "cuda":
        return _dom.dominance_matrix_cuda(F)
    raise ValueError(f"no dominance_matrix for device {F.device}")
