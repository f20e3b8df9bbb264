"""Kernel entry points, dispatched by the device of the input tensor.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``); a CUDA
tensor goes to the hand-written kernel, which launches or raises. There is no
fallback from one to the other and no mode that hides which path ran.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import decode_attention as _dec
from . import dominance as _dom
from . import flash_attention as _fa
from . import paged_attention as _paged
from . import ref


def dominance_matrix(F: torch.Tensor) -> torch.Tensor:
    """(P, M) -> (P, P) bool Pareto dominance matrix (minimization)."""
    if F.device.type == "cpu":
        return ref.dominance_matrix(F)
    if F.device.type == "cuda":
        return _dom.dominance_matrix_cuda(F)
    raise ValueError(f"no dominance_matrix for device {F.device}")


def dominance_counts(F: torch.Tensor) -> torch.Tensor:
    """(P, M) -> (P,) int32 dominator counts (minimization)."""
    if F.device.type == "cpu":
        return ref.dominance_counts(F)
    if F.device.type == "cuda":
        return _dom.dominance_counts_cuda(F)
    raise ValueError(f"no dominance_counts for device {F.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, Hq, S, D) x (B, Hkv, S, D) -> (B, Hq, S, D) GQA attention.

    Differentiable: on the CPU autograd runs through the plain version; on
    the card an input that requires grad goes through
    ``flash_attention.FlashAttention`` (the backward kernels), and without
    grad the call is the forward kernel alone."""
    if q.device.type == "cpu":
        return ref.mha_prefill(q, k, v, causal=causal)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _fa.FlashAttention.apply(q, k, v, causal)
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


def gqa_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, kv_len: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Hq, D) over one block (B, Hkv, S_r, D) of a cache split by
    position, filled to kv_len (B,) in the block: (o (B, Hq, D) f32, lse
    (B, Hq) f32), merged across blocks by
    ``tensor_parallel.merge_partials``."""
    if q.device.type == "cpu":
        return ref.gqa_decode_partial(q, k_cache, v_cache, kv_len)
    if q.device.type == "cuda":
        return _dec.gqa_decode_partial_cuda(q, k_cache, v_cache, kv_len)
    raise ValueError(f"no gqa_decode_partial for device {q.device}")


def flash_attention_extend(q: torch.Tensor, k_pre: torch.Tensor,
                           v_pre: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           prefix_len: Optional[int] = None) -> torch.Tensor:
    """Suffix queries (B, Hq, Sq, D) over the first ``prefix_len`` rows of a
    cached prefix (B, Hkv, S_pre, D), then causally over the suffix's own
    (B, Hkv, Sq, D) keys; ``prefix_len=None`` is S_pre."""
    if q.device.type == "cpu":
        return ref.mha_prefill_extend(q, k_pre, v_pre, k, v, prefix_len)
    if q.device.type == "cuda":
        return _fa.flash_attention_extend_cuda(q, k_pre, v_pre, k, v,
                                               prefix_len)
    raise ValueError(f"no flash_attention_extend for device {q.device}")


def paged_gqa_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               kv_len: torch.Tensor) -> torch.Tensor:
    """(B, Hq, D) over (n_blocks, Hkv, block_size, D) pools addressed by a
    (B, max_blocks) block table, filled to kv_len (B,)."""
    if q.device.type == "cpu":
        return ref.paged_gqa_decode(q, k_pool, v_pool, block_table, kv_len)
    if q.device.type == "cuda":
        return _paged.paged_gqa_decode_attention_cuda(q, k_pool, v_pool,
                                                      block_table, kv_len)
    raise ValueError(f"no paged_gqa_decode_attention for device {q.device}")
