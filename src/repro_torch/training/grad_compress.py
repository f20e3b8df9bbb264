"""Gradient compression operators: the counterpart of
``repro.training.grad_compress``.

For the cross-pod data-parallel all-reduce the reference compresses the
gradients it sends:

* ``int8`` — error-feedback blockwise int8: quantize (grad + residual),
  send the int8 payload (4x less traffic than f32), keep the quantization
  error as the residual for the next step, so the sum of what was sent and
  the residual telescopes to the sum of the gradients;
* ``topk`` — error-feedback magnitude top-k a tensor (k as a fraction of
  its size), sent dense-masked.

Gradients and residuals are dicts of tensors keyed by parameter name; the
functions are pure. ``psum_compressed`` is the reduction: the mean of every
rank's gradients over a process group (a named mesh dimension's, through
``DeviceMesh.get_group(axis)``), sent compressed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

QBLOCK = 256

Tensors = Dict[str, torch.Tensor]


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x in blocks of up to :data:`QBLOCK` along its last axis -> (int8
    (..., n_blocks, block), f32 scales (..., n_blocks, 1)); round half to
    even, as ``jnp.round``."""
    last = x.shape[-1]
    block = min(QBLOCK, max(last, 1))
    pad = (-last) % block
    xp = F.pad(x, (0, pad))
    xb = xp.reshape(x.shape[:-1] + (-1, block))
    s = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, 1.0, s)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return q, s


def _dequantize_int8(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    xf = q.to(torch.float32) * s
    return xf.reshape(tuple(shape[:-1]) + (-1,))[..., :shape[-1]]


def compress_int8(grads: Tensors, residual: Tensors
                  ) -> Tuple[Tensors, Tensors, Tensors]:
    """(int8 payloads, scales, new residuals): the residual is the error of
    this step's local quantization (standard error feedback)."""
    qs, ss, rs = {}, {}, {}
    for k, g in grads.items():
        gf = g.to(torch.float32) + residual[k]
        qs[k], ss[k] = _quantize_int8(gf)
        rs[k] = gf - _dequantize_int8(qs[k], ss[k], gf.shape)
    return qs, ss, rs


def decompress_int8(payload: Tensors, scales: Tensors,
                    grads_template: Tensors) -> Tensors:
    return {k: _dequantize_int8(payload[k], scales[k], g.shape)
            for k, g in grads_template.items()}


def compress_topk(grads: Tensors, residual: Tensors, frac: float = 0.05
                  ) -> Tuple[Tensors, Tensors]:
    """Error-feedback top-|frac| sparsification (dense-masked): (sent, new
    residuals); every entry at least as large as the k-th largest is
    sent."""
    sent, rs = {}, {}
    for key, g in grads.items():
        gf = g.to(torch.float32) + residual[key]
        flat = gf.reshape(-1)
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        mask = (torch.abs(gf) >= thresh).to(torch.float32)
        sent[key] = gf * mask
        rs[key] = gf - sent[key]
    return sent, rs


def init_residual(grads_or_params: Tensors) -> Tensors:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_or_params.items()}


def psum_compressed(grads: Tensors, residual: Tensors, group=None,
                    method: str = "int8") -> Tuple[Tensors, Tensors]:
    """All-reduce ``grads`` over the process group ``group`` (default: the
    world; a mesh axis's is ``mesh.get_group("pod")``) with error-feedback
    compression: (the mean gradients in f32, the new residuals).

    * ``int8``: each rank's int8 payload summed in int32 (no overflow across
      ranks), the scales averaged, and the sum over the count dequantized
      with the mean scales, as the reference's arithmetic;
    * ``topk``: the dense-masked sent values summed and divided by the
      count;
    * otherwise no compression: the f32 gradients' mean, residuals
      unchanged.

    Every rank must call it with the same keys in the same order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def psum(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    if method == "int8":
        q, s, new_res = compress_int8(grads, residual)
        mean = {}
        for k, g in grads.items():
            summed = psum(q[k].to(torch.int32))
            s_mean = psum(s[k]) / n
            mean[k] = _dequantize_int8(summed.to(torch.float32) / n, s_mean,
                                       g.shape)
        return mean, new_res
    if method == "topk":
        sent, new_res = compress_topk(grads, residual)
        return {k: psum(x) / n for k, x in sent.items()}, new_res
    return ({k: psum(g.to(torch.float32)) / n for k, g in grads.items()},
            residual)
