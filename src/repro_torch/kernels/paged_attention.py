"""Grouped-query decode attention over a paged KV pool: the CUDA kernel's
wrapper.

The kernel (``csrc/paged_attention.cu``, the split decode kernel of
``csrc/split_decode.cuh`` with paged row addresses) replaces the TPU kernel
``paged_gqa_decode_attention`` of ``src/repro/kernels/paged_attention.py``;
the source notes say what bounds it and how the design answers. The wrapper
checks its inputs, splits the positions as the decode wrapper does
(``decode_attention.decode_split`` over max_blocks * block_size), allocates
the output and the blocks' f32 scratch, launches on PyTorch's current stream
and counts the launch. It takes CUDA tensors only: the dispatch by
device lives in ``kernels.ops``. The serving engine does not decode over
the pool (it gathers a matched prefix into the slot's contiguous cache, as
the reference engine does), so no serving path launches it yet.
"""
from __future__ import annotations

import torch

from . import _build
from .decode_attention import (DTYPES, _tickets, check_alignment,
                               check_attention_inputs, decode_split)

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
    read, nor the table entries that name them; a row with kv_len <= 0
    gives zeros. The pools' pointers and strides must be 16-byte aligned
    and D a multiple of 8 (``decode_attention.check_alignment``). On the
    same rows the result equals the decode kernel's on the gathered
    (B, Hkv, max_blocks * block_size, D) cache, bit for bit."""
    global LAUNCHES
    name = "paged_gqa_decode_attention_cuda"
    check_attention_inputs(name, q, k_pool, v_pool, 3, batched=False)
    check_alignment(name, k_pool, v_pool)
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
    bt, lens = block_table, kv_len
    if bt.dtype != torch.int32 or bt.stride(1) != 1:
        bt = bt.to(torch.int32).contiguous()
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        lens = lens.to(torch.int32).contiguous()
    mb = bt.shape[1]
    span, splits = decode_split(B, Hkv, mb * bs, _build.n_sm(q.device))
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load()
    with _build.on_device(q.device):
        stream = _build.stream(q.device)
        err = lib.repro_paged_gqa_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            bt.data_ptr(), lens.data_ptr(), out.data_ptr(), part.data_ptr(),
            _tickets(q.device, stream, B * Hkv).data_ptr(), B, Hq, Hkv, mb,
            bs, D, DTYPES[q.dtype], span, splits, q.stride(0), q.stride(1),
            *k_pool.stride()[:3], *v_pool.stride()[:3], bt.stride(0),
            out.stride(0), out.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"paged decode attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
