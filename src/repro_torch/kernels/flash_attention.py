"""Grouped-query flash attention: the CUDA kernel's wrapper.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernel
``flash_attention`` of ``src/repro/kernels/flash_attention.py``; the source
note says what bounds them and how each design answers. One C entry point
chooses by the input's type (:func:`route`): bf16 runs on the tensor cores
(``wgmma``), with one or two warpgroups a block (:func:`flash_groups`),
f32 on the CUDA cores, whose f32 math alone meets the f32 tolerance. Unlike the TPU kernel they mask their own ragged tiles, so any
sequence length runs as it is. The prefix-extend variant (suffix queries
over a cached prefix, then causally over the suffix) is the same kernels
and the same launch counter. The wrappers check their inputs, allocate the
output, launch on PyTorch's current stream and count the launch. They take
CUDA tensors only: the dispatch by device lives in ``kernels.ops``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .decode_attention import DTYPES, check_alignment, check_attention_inputs

#: query rows of one block of the tensor-core kernel, and keys of one tile
TILE = 64

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0


def route(dtype: torch.dtype) -> str:
    """Which kernel the C entry point runs for ``dtype``: "wgmma" (bf16,
    the tensor cores) or "cuda_cores" (f32)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"flash attention takes float32 or bfloat16, got "
                     f"{dtype}")


def flash_groups(S: int, prefix_len: int) -> int:
    """Warpgroups per block of the tensor-core kernel: 2 where the longest
    row (the last q tile's) has a second key tile for the second warpgroup,
    else 1. ``chip_smoke.py`` times both on the card: one is faster for a
    single tile (S 64); two at S 128, S 512 and for the extend variant,
    and no slower at S 1,088, whose grid holds more blocks than SMs."""
    return 2 if -(-prefix_len // TILE) - (-S // TILE) >= 2 else 1


def _launch(q, k, v, k_pre, v_pre, prefix_len: int,
            causal: bool) -> torch.Tensor:
    """One launch; prefix_len = 0 leaves k_pre, v_pre unread. The tensor
    cores' kernel loads its tiles by 16-byte copies, so its inputs must be
    aligned (:func:`check_alignment`)."""
    global LAUNCHES
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    groups = 1
    if route(q.dtype) == "wgmma":
        check_alignment("flash_attention_cuda", q, k, v,
                        *((k_pre, v_pre) if prefix_len else ()))
        groups = flash_groups(S, prefix_len)
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lib = _build.load()
    with _build.on_device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pre.data_ptr(),
            v_pre.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, S, prefix_len, D, int(causal), DTYPES[q.dtype],
            groups,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *k_pre.stride()[:3], *v_pre.stride()[:3], *out.stride()[:3],
            _build.stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) of one dtype (f32 or bf16) on a
    CUDA device -> (B, Hq, S, D) in q's dtype; query head h reads kv head
    h // (Hq // Hkv).

    Inputs may be any strided views whose head dim is contiguous (the
    model's (B, S, H, D) projections transposed are read in place). The
    result is a (B, Hq, S, D) view of a (B, S, Hq, D) buffer, so the model
    transposes it back for free."""
    check_attention_inputs("flash_attention_cuda", q, k, v, 4)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"q has {q.shape[2]} positions, k and v "
                         f"{k.shape[2]}")
    return _launch(q, k, v, k, v, 0, causal)


def flash_attention_extend_cuda(q: torch.Tensor, k_pre: torch.Tensor,
                                v_pre: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                prefix_len: Optional[int] = None
                                ) -> torch.Tensor:
    """The prefix-extend variant: suffix queries q (B, Hq, S, D) over the
    first ``prefix_len`` rows of a cached prefix k_pre/v_pre (B, Hkv, S_pre,
    D), all visible, then the suffix's own k/v (B, Hkv, S, D) causally.
    ``prefix_len=None`` is S_pre (the exact-length mode); a smaller one is
    the bucketed mode, whose rows past it are never read. Strides and the
    result's layout as in :func:`flash_attention_cuda`."""
    check_attention_inputs("flash_attention_extend_cuda", q, k, v, 4)
    check_attention_inputs("flash_attention_extend_cuda", q, k_pre, v_pre,
                           4)
    S_pre = k_pre.shape[2]
    plen = S_pre if prefix_len is None else int(prefix_len)
    if (k.shape[2] != q.shape[2] or k_pre.shape[1] != k.shape[1]
            or not 0 <= plen <= S_pre):
        raise ValueError(f"q has {q.shape[2]} positions, k and v "
                         f"{k.shape[2]}; prefix heads {k_pre.shape[1]}, "
                         f"suffix heads {k.shape[1]}; prefix_len {plen} of "
                         f"{S_pre}")
    return _launch(q, k, v, k_pre, v_pre, plen, True)
