"""Grouped-query decode attention over a paged KV pool: the CUDA kernel's
wrapper.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_gqa_decode_attention`` of ``src/repro/kernels/paged_attention.py``;
its source note says what bounds it and how the design answers. The wrapper
checks its inputs, allocates the output, launches on PyTorch's current
stream and counts the launch. It takes CUDA tensors only: the dispatch by
device lives in ``kernels.ops``. The serving engine does not decode over
the pool (it gathers a matched prefix into the slot's contiguous cache, as
the reference engine does), so no serving path launches it yet.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import DTYPES, _ptr, check_attention_inputs

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0


def paged_gqa_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    block_table: torch.Tensor,
                                    kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D), k/v pools (n_blocks, Hkv, block_size, D) of one dtype
    (f32 or bf16), block_table (B, max_blocks) integer ids, kv_len (B,), on
    a CUDA device -> (B, Hq, D) in q's dtype.

    The pools may be any strided views whose head dim is contiguous, such
    as one layer of the serving store's (n_blocks, block_size, Hkv, D) pool
    permuted: the kernel reads them in place. Row b's position p lies in
    block ``max(block_table[b, p // block_size], 0)``; ids must be below
    n_blocks. Positions >= min(kv_len, max_blocks * block_size) are never
    read; a row with kv_len <= 0 gives zeros."""
    global LAUNCHES
    check_attention_inputs("paged_gqa_decode_attention_cuda", q, k_pool,
                           v_pool, 3, batched=False)
    B, Hq, D = q.shape
    Hkv, bs = k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[0] < 1 or bs < 1:
        raise ValueError(f"empty pool {tuple(k_pool.shape)}")
    if (block_table.dim() != 2 or block_table.shape[0] != B
            or block_table.shape[1] < 1 or block_table.is_floating_point()
            or block_table.device != q.device):
        raise ValueError(f"block_table must be ({B}, max_blocks) integer ids "
                         f"on {q.device}, got {tuple(block_table.shape)} "
                         f"{block_table.dtype} on {block_table.device}")
    if kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"kv_len must be ({B},) on {q.device}, got "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    bt = block_table.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_paged_gqa_decode(
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(bt), _ptr(lens),
            _ptr(out), B, Hq, Hkv, bt.shape[1], bs, D, DTYPES[q.dtype],
            q.stride(0), q.stride(1), *k_pool.stride()[:3],
            *v_pool.stride()[:3], bt.stride(0), out.stride(0), out.stride(1),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"paged decode attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
