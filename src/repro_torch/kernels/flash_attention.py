"""Grouped-query flash attention: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention`` of ``src/repro/kernels/flash_attention.py``; its source
note says what bounds it and how the design answers. Unlike the TPU kernel
it masks its own ragged tiles, so any sequence length runs as it is. The
wrapper checks its inputs, allocates the output, launches on PyTorch's
current stream and counts the launch. It takes CUDA tensors only: the
dispatch by device lives in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import DTYPES, _ptr, check_attention_inputs

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) of one dtype (f32 or bf16) on a
    CUDA device -> (B, Hq, S, D) in q's dtype; query head h reads kv head
    h // (Hq // Hkv).

    Inputs may be any strided views whose head dim is contiguous (the
    model's (B, S, H, D) projections transposed are read in place). The
    result is a (B, Hq, S, D) view of a (B, S, Hq, D) buffer, so the model
    transposes it back for free."""
    global LAUNCHES
    check_attention_inputs("flash_attention_cuda", q, k, v, 4)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape[2] != S:
        raise ValueError(f"q has {S} positions, k and v {k.shape[2]}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, Hq, Hkv, S, D,
            int(causal), DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
