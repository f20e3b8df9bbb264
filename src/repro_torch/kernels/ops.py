"""Kernel entry points, dispatched by the device of the input tensor.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``); a CUDA
tensor goes to the hand-written kernel, which launches or raises. There is no
fallback from one to the other and no mode that hides which path ran.
"""
from __future__ import annotations

import torch

from . import decode_attention as _dec
from . import dominance as _dom
from . import flash_attention as _fa
from . import ref


def dominance_matrix(F: torch.Tensor) -> torch.Tensor:
    """(P, M) -> (P, P) bool Pareto dominance matrix (minimization)."""
    if F.device.type == "cpu":
        return ref.dominance_matrix(F)
    if F.device.type == "cuda":
        return _dom.dominance_matrix_cuda(F)
    raise ValueError(f"no dominance_matrix for device {F.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, Hq, S, D) x (B, Hkv, S, D) -> (B, Hq, S, D) GQA attention."""
    if q.device.type == "cpu":
        return ref.mha_prefill(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal)
    raise ValueError(f"no flash_attention for device {q.device}")


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """(B, Hq, D) over a (B, Hkv, Smax, D) cache filled to kv_len (B,)."""
    if q.device.type == "cpu":
        return ref.gqa_decode(q, k_cache, v_cache, kv_len)
    if q.device.type == "cuda":
        return _dec.gqa_decode_attention_cuda(q, k_cache, v_cache, kv_len)
    raise ValueError(f"no gqa_decode_attention for device {q.device}")
