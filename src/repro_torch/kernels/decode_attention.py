"""Grouped-query decode attention: the CUDA kernel's wrapper.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``gqa_decode_attention`` of ``src/repro/kernels/decode_attention.py``; its
source note says what bounds it and how the design answers. The wrapper
checks its inputs, picks how the positions are split over blocks
(:func:`decode_split`), allocates the output and the blocks' f32 scratch,
launches on PyTorch's current stream and counts the launch. Its partial
mode (:func:`gqa_decode_partial_cuda`) runs over one rank's block of a
cache split by position and returns the f32 result with its log-sum-exp;
its launches count among the kernel's and alone (``PARTIAL_LAUNCHES``).
It takes CUDA tensors only: the dispatch by device lives in
``kernels.ops``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: positions one block covers per step (4 warps x 32): a span's multiple
SPAN_STEP = 128

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0
#: of those, the partial mode's
PARTIAL_LAUNCHES = 0


def check_attention_inputs(name: str, q, k, v, q_dims: int,
                           batched: bool = True) -> None:
    """Shape, type, device and layout checks shared by the attention
    wrappers; ``batched=False`` for a pool, whose first dim is its
    blocks."""
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
    if ((batched and k.shape[0] != B) or k.shape[-1] != D or Hkv < 1
            or Hq % Hkv):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (need Hq % Hkv == 0)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} outside 1..{MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{name}: the head dim must be contiguous")


def check_alignment(name: str, *ts: torch.Tensor) -> None:
    """The 16-byte copies (``cp.async``) need every data pointer, every
    stride times the element size and the head dim's bytes to be multiples
    of 16 (D % 8 == 0 in bf16); raise ``ValueError`` on what they do not
    take. Plain host arithmetic on pointers and strides, for any device."""
    for t in ts:
        es = t.element_size()
        if t.shape[-1] % 8:
            raise ValueError(f"{name}: head dim {t.shape[-1]} is not a "
                             f"multiple of 8")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer {t.data_ptr():#x} is "
                             f"not 16-byte aligned")
        if any(st * es % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{name}: strides {tuple(t.stride())} of "
                             f"{es}-byte elements are not multiples of 16 "
                             f"bytes")


@functools.lru_cache(maxsize=256)
def decode_split(B: int, Hkv: int, Smax: int, n_sm: int) -> Tuple[int, int]:
    """(span, splits): the positions of each (b, kv head) go to ``splits``
    blocks of ``span`` positions each, a multiple of :data:`SPAN_STEP`.

    Chosen from the shapes alone (kv_len lives on the card): the smallest
    span that keeps the grid within ~4 blocks per SM, so that B * Hkv *
    splits >= 2 * n_sm where Smax allows (128 positions give 4 splits at
    Smax 512 and 9 at 1,088 for B 8 x Hkv 8 on 132 SMs), while a large
    batch keeps few splits and so a cheap merge."""
    steps = -(-Smax // SPAN_STEP)
    most = max(1, -(-4 * n_sm // (B * Hkv)))
    span = SPAN_STEP * -(-steps // min(steps, most))
    return span, -(-Smax // span)


#: one int32 ticket per (b, kv head), by (device, stream): zero between
#: calls (the merging block resets its own), so no call needs a memset.
#: Calls on one stream run in order and share a buffer; a call on another
#: stream gets a buffer of its own, so two streams never race on a ticket.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(
            max(n, 64), dtype=torch.int32, device=device)
    return t


def gqa_decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D), k/v cache (B, Hkv, Smax, D) of one dtype (f32 or
    bf16), kv_len (B,) on a CUDA device -> (B, Hq, D) in q's dtype.

    The cache may be any strided view whose head dim is contiguous, such as
    one layer of the engine's (B, Smax, Hkv, D) cache permuted: the kernel
    reads it in place. Positions >= min(kv_len, Smax) are never read; a row
    with kv_len <= 0 gives zeros. The cache's pointers and strides must be
    16-byte aligned and D a multiple of 8 (:func:`check_alignment`)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("gqa_decode_attention_cuda", q, k_cache, v_cache, kv_len, out)
    return out


def gqa_decode_partial_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, kv_len: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial mode, over one block of a cache whose positions are
    split: as :func:`gqa_decode_attention_cuda`, but returns (o (B, Hq, D)
    f32, lse (B, Hq) f32): ``o`` the normalized result that the default
    mode rounds to q's dtype, bit for bit, and lse = m + log(l) of the
    scaled scores; a row with kv_len <= 0 gives o = 0 and lse = -inf.
    ``tensor_parallel.merge_partials`` merges the blocks' results."""
    B, Hq, D = q.shape
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    _launch("gqa_decode_partial_cuda", q, k_cache, v_cache, kv_len, out,
            lse)
    return out, lse


def _launch(name: str, q: torch.Tensor, k_cache: torch.Tensor,
            v_cache: torch.Tensor, kv_len: torch.Tensor, out: torch.Tensor,
            lse: Optional[torch.Tensor] = None) -> None:
    """Check the inputs, split the positions, launch the default mode
    into ``out`` (or, with ``lse``, the partial mode) and count it."""
    global LAUNCHES, PARTIAL_LAUNCHES
    check_attention_inputs(name, q, k_cache, v_cache, 3)
    check_alignment(name, k_cache, v_cache)
    B, Hq, D = q.shape
    Hkv, Smax = k_cache.shape[1], k_cache.shape[2]
    if kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"kv_len must be ({B},) on {q.device}, got "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    lens = kv_len
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        lens = lens.to(torch.int32).contiguous()
    span, splits = decode_split(B, Hkv, Smax, _build.n_sm(q.device))
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load()
    with _build.on_device(q.device):
        stream = _build.stream(q.device)
        head = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lens.data_ptr(), out.data_ptr())
        args = (part.data_ptr(),
                _tickets(q.device, stream, B * Hkv).data_ptr(), B, Hq, Hkv,
                Smax, D, DTYPES[q.dtype], span, splits, q.stride(0),
                q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3],
                out.stride(0), out.stride(1), stream)
        if lse is None:
            err = lib.repro_gqa_decode(*head, *args)
        else:
            err = lib.repro_gqa_decode_partial(*head, lse.data_ptr(), *args)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    PARTIAL_LAUNCHES += lse is not None
