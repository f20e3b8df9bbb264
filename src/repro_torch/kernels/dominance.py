"""Pareto dominance matrix: the CUDA kernel's wrapper.

The kernel (``csrc/dominance.cu``) replaces the TPU kernel
``dominance_matrix_pallas`` of ``src/repro/kernels/dominance.py``; its source
note says what bounds it and how the design answers. The wrapper checks the
input, allocates the output, launches on PyTorch's current stream and counts
the launch. It takes CUDA tensors only: the dispatch by device lives in
``kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_OBJECTIVES = 32

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0


def dominance_matrix_cuda(F: torch.Tensor) -> torch.Tensor:
    """(P, M) floating objectives on a CUDA device -> (P, P) bool.

    F is cast to f32 (as the TPU kernel does) and made contiguous; the
    kernel writes uint8 and the result is a ``torch.bool`` view of it."""
    global LAUNCHES
    if F.device.type != "cuda":
        raise ValueError(f"dominance_matrix_cuda needs a CUDA tensor, got "
                         f"{F.device}")
    if F.dim() != 2 or not F.is_floating_point():
        raise ValueError(f"F must be a 2-D floating tensor, got "
                         f"{tuple(F.shape)} {F.dtype}")
    P, M = F.shape
    if P < 1 or not 1 <= M <= MAX_OBJECTIVES:
        raise ValueError(f"need P >= 1 and 1 <= M <= {MAX_OBJECTIVES}, got "
                         f"P={P}, M={M}")
    F32 = F.to(torch.float32).contiguous()
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
