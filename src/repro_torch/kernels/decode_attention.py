"""Grouped-query decode attention: the CUDA kernel's wrapper.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``gqa_decode_attention`` of ``src/repro/kernels/decode_attention.py``; its
source note says what bounds it and how the design answers. The wrapper
checks its inputs, allocates the output, launches on PyTorch's current
stream and counts the launch. It takes CUDA tensors only: the dispatch by
device lives in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_attention_inputs(name: str, q, k, v, q_dims: int) -> None:
    """Shape, type, device and layout checks shared by both wrappers."""
    ts = (q, k, v)
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"{name} needs CUDA tensors, got "
                         f"{[str(t.device) for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16 q, k, v of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, D = q.shape[0], q.shape[1], q.shape[-1]
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[-1] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (need Hq % Hkv == 0)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} outside 1..{MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{name}: the head dim must be contiguous")


def gqa_decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D), k/v cache (B, Hkv, Smax, D) of one dtype (f32 or
    bf16), kv_len (B,) on a CUDA device -> (B, Hq, D) in q's dtype.

    The cache may be any strided view whose head dim is contiguous, such as
    one layer of the engine's (B, Smax, Hkv, D) cache permuted: the kernel
    reads it in place. Positions >= min(kv_len, Smax) are never read; a row
    with kv_len <= 0 gives zeros."""
    global LAUNCHES
    check_attention_inputs("gqa_decode_attention_cuda", q, k_cache, v_cache,
                           3)
    B, Hq, D = q.shape
    Hkv, Smax = k_cache.shape[1], k_cache.shape[2]
    if kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"kv_len must be ({B},) on {q.device}, got "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_gqa_decode(
            _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(lens), _ptr(out),
            B, Hq, Hkv, Smax, D, DTYPES[q.dtype],
            q.stride(0), q.stride(1),
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            out.stride(0), out.stride(1), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
