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

Training adds the gradient (``csrc/flash_attention_bwd.cu``, its own
counter :data:`BWD_LAUNCHES`): the forward also writes each row's
log-sum-exp (:func:`flash_attention_lse_cuda`), and
:func:`flash_attention_backward_cuda` launches the two backward kernels,
dq (which also writes D = rowsum(dO o O)) and then dk/dv. They too are
chosen by type (:func:`backward_route`): bf16 on the tensor cores in tiles
of :data:`BWD_WGMMA_TILE`, f32 on the CUDA cores in tiles of
:data:`BWD_TILE`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .decode_attention import DTYPES, check_alignment, check_attention_inputs

#: query rows of one block of the tensor-core kernel, and keys of one tile
TILE = 64

#: kernel launches since the last reset (a run sets it to 0, then reads it)
LAUNCHES = 0
#: backward kernel launches since the last reset, two a backward pass
BWD_LAUNCHES = 0
#: the backward's kernels a backward pass: dq (with D), then dk/dv
BWD_KERNELS = 2
#: query rows and keys of one tile of the f32 backward kernels (CUDA cores)
BWD_TILE = 32
#: query rows and keys of one tile of the bf16 backward kernels (``wgmma``)
BWD_WGMMA_TILE = 64


def route(dtype: torch.dtype) -> str:
    """Which kernel the C entry point runs for ``dtype``: "wgmma" (bf16,
    the tensor cores) or "cuda_cores" (f32)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"flash attention takes float32 or bfloat16, got "
                     f"{dtype}")


def backward_route(dtype: torch.dtype) -> str:
    """Which backward kernels the C entry points run for ``dtype``:
    "wgmma" (bf16: ``flash_bwd_dq_wgmma`` and ``flash_bwd_dkdv_wgmma``, the
    tensor cores, P and dS rounded to bf16) or "cuda_cores" (f32:
    ``flash_bwd_dq_kernel`` and ``flash_bwd_dkdv_kernel``, f32 math, which
    alone meets the f32 tolerance)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"the flash backward takes float32 or bfloat16, got "
                     f"{dtype}")


def flash_groups(S: int, prefix_len: int) -> int:
    """Warpgroups per block of the tensor-core kernel: 2 where the longest
    row (the last q tile's) has a second key tile for the second warpgroup,
    else 1. ``chip_smoke.py`` times both on the card: one is faster for a
    single tile (S 64); two at S 128, S 512 and for the extend variant,
    and no slower at S 1,088, whose grid holds more blocks than SMs."""
    return 2 if -(-prefix_len // TILE) - (-S // TILE) >= 2 else 1


def _launch(q, k, v, k_pre, v_pre, prefix_len: int, causal: bool,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch; prefix_len = 0 leaves k_pre, v_pre unread; ``lse``, a
    contiguous f32 (B, Hq, S), gets each row's log-sum-exp when given. The
    tensor cores' kernel loads its tiles by 16-byte copies, so its inputs
    must be aligned (:func:`check_alignment`)."""
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
            None if lse is None else lse.data_ptr(),
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
    return _full(q, k, v, causal)


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_cuda` that also returns each row's
    log-sum-exp of its scaled scores, f32 (B, Hq, S) (+inf for a row that
    met no key): what the backward recomputes P from. The output's bits
    are those of the call without it."""
    B, Hq, S, _ = q.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    return _full(q, k, v, causal, lse), lse


def _full(q, k, v, causal: bool, lse: Optional[torch.Tensor] = None):
    check_attention_inputs("flash_attention_cuda", q, k, v, 4)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"q has {q.shape[2]} positions, k and v "
                         f"{k.shape[2]}")
    return _launch(q, k, v, k, v, 0, causal, lse)


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialized (B, H, S, D) view of a (B, S, H, D) buffer: the
    layout of the model's projections, whose gradients these are."""
    B, H, S, D = t.shape
    return torch.empty((B, S, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, dout: torch.Tensor,
                                  causal: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_cuda` at (q, k, v), given its
    output ``out``, the forward's ``lse`` and the output's gradient
    ``dout`` (q's shape). The kernels follow :func:`backward_route`: bf16
    products on the tensor cores with f32 sums (P and dS rounded to bf16),
    f32 math on the CUDA cores for f32. The gradients come back in the
    input's type, as (B, H, S, D) views of (B, S, H, D) buffers.
    Deterministic: two calls give the same bits. Two launches, both counted
    in :data:`BWD_LAUNCHES`. bf16 inputs must be aligned as the forward's
    (:func:`check_alignment`: the tensor cores' kernels load 16-byte
    chunks)."""
    global BWD_LAUNCHES
    name = "flash_attention_backward_cuda"
    check_attention_inputs(name, q, k, v, 4)
    check_attention_inputs(name, out, k, v, 4)
    check_attention_inputs(name, dout, k, v, 4)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if (k.shape[2] != S or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, Hq, S) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if backward_route(q.dtype) == "wgmma":
        check_alignment(name, q, k, v, out, dout)
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    dsum = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = _build.load()
    st = _build.stream(q.device)
    with _build.on_device(q.device):
        err = lib.repro_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            B, Hq, Hkv, S, D, int(causal), DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *dout.stride()[:3], *dq.stride()[:3], st)
        if err != 0:
            raise RuntimeError(f"flash attention backward (dq) launch "
                               f"failed: cudaError {err}")
        BWD_LAUNCHES += 1
        err = lib.repro_flash_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hkv, S, D, int(causal), DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], st)
        if err != 0:
            raise RuntimeError(f"flash attention backward (dk/dv) launch "
                               f"failed: cudaError {err}")
        BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its gradient: the forward launches the kernel
    with the lse and saves q, k, v, the output and the lse; the backward
    launches the backward kernels. Under activation checkpointing the
    recompute relaunches the forward, and the backward reads the lse of
    that launch, saved with its output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_lse_cuda(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                                   ctx.causal)
        return dq, dk, dv, None


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
