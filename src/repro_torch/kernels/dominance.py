"""Pareto dominance: the CUDA kernels' wrappers.

The kernels (``csrc/dominance.cu``) replace the TPU kernels
``dominance_matrix_pallas`` and ``dominance_counts_pallas`` of
``src/repro/kernels/dominance.py``; the source notes say what bounds each and
how the design answers. A wrapper checks the input, allocates the output,
launches on PyTorch's current stream and counts the launch. They take CUDA
tensors only: the dispatch by device lives in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_OBJECTIVES = 32

#: matrix kernel launches since the last reset (a run sets it to 0, then
#: reads it)
LAUNCHES = 0
#: counts kernel launches since the last reset
COUNTS_LAUNCHES = 0


def _objectives(name: str, F: torch.Tensor) -> torch.Tensor:
    """F checked, cast to f32 (as the TPU kernels do) and contiguous."""
    if F.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {F.device}")
    if F.dim() != 2 or not F.is_floating_point():
        raise ValueError(f"F must be a 2-D floating tensor, got "
                         f"{tuple(F.shape)} {F.dtype}")
    P, M = F.shape
    if P < 1 or not 1 <= M <= MAX_OBJECTIVES:
        raise ValueError(f"need P >= 1 and 1 <= M <= {MAX_OBJECTIVES}, got "
                         f"P={P}, M={M}")
    return F.to(torch.float32).contiguous()


def dominance_matrix_cuda(F: torch.Tensor) -> torch.Tensor:
    """(P, M) floating objectives on a CUDA device -> (P, P) bool.

    The kernel writes uint8 and the result is a ``torch.bool`` view of it."""
    global LAUNCHES
    F32 = _objectives("dominance_matrix_cuda", F)
    P, M = F32.shape
    out = torch.empty((P, P), dtype=torch.uint8, device=F.device)
    lib = _build.load()
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_dominance_matrix(
            ctypes.c_void_p(F32.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            P, M, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dominance kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out.view(torch.bool)


def dominance_counts_cuda(F: torch.Tensor) -> torch.Tensor:
    """(P, M) floating objectives on a CUDA device -> (P,) int32, the number
    of rows dominating each row; the (P, P) matrix is never stored."""
    global COUNTS_LAUNCHES
    F32 = _objectives("dominance_counts_cuda", F)
    P, M = F32.shape
    out = torch.empty((P,), dtype=torch.int32, device=F.device)
    lib = _build.load()
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_dominance_counts(
            ctypes.c_void_p(F32.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            P, M, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dominance counts kernel launch failed: "
                           f"cudaError {err}")
    COUNTS_LAUNCHES += 1
    return out
