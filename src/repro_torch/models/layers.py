"""Core layer math of the dense LM: the counterpart of the dense subset of
``repro.models.layers``.

Parameters live in the ``nn.Module``s of ``models/lm.py``; these are plain
functions on tensors. Dense weights keep the reference's (d_in, d_out)
layout, so ``x @ w`` is its ``einsum("bsd,de->bse")``. As in the reference,
norms, rope, softmax and the unembedding run in f32 and the projections in
the model's dtype. Attention goes through ``kernels.ops``: the plain
version for CPU tensors, the hand-written kernel for CUDA tensors.
Sharding constraints, cross-attention and prefix-extension prefill are not
ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# norms / rope / embeddings
# ---------------------------------------------------------------------------

def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * g).to(x.dtype)


def layer_norm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def apply_norm(cfg: ModelConfig, norm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` is a ``models.lm.Norm`` (gain ``g``, and bias ``b`` for a
    layernorm)."""
    if cfg.norm == "rmsnorm":
        return rms_norm(norm.g, x, cfg.norm_eps)
    return layer_norm(norm.g, norm.b, x, cfg.norm_eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated pairwise (halves); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., vocab) logits in f32."""
    return x.to(torch.float32) @ table.to(torch.float32).T


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(p, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor):
    """Projections of the ``models.lm.Attention`` ``p``: q (B, S, Hq, D),
    k and v (B, S, Hkv, D), with qk-norm where the config has it."""
    B = x.shape[0]
    q = (x @ p.wq).reshape(B, -1, cfg.n_heads, cfg.hd)
    k = (kv_x @ p.wk).reshape(B, -1, cfg.n_kv_heads, cfg.hd)
    v = (kv_x @ p.wv).reshape(B, -1, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(p.qnorm, q, cfg.norm_eps)
        k = rms_norm(p.knorm, k, cfg.norm_eps)
    return q, k, v


def _self_attention(q, k, v, causal: bool) -> torch.Tensor:
    """(B, S, H, D) in, (B, S, Hq, D) out, through ``ops.flash_attention``
    (which takes (B, H, S, D) views: no copies on the card)."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def attention(p, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (``train_logits``)."""
    q, k, v = _qkv(p, cfg, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _self_attention(q, k, v, causal)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.q_dim) @ p.wo


def attention_prefill_cache(p, cfg: ModelConfig, x: torch.Tensor,
                            positions: torch.Tensor
                            ) -> Tuple[torch.Tensor,
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """Like ``attention`` (causal), and also returns the (k, v) cache, each
    (B, S, Hkv, D).

    The reference computes this with its XLA einsum path
    (``_xla_attention``); the port runs the flash kernel here, the same
    function, since the reference's kernel module itself names prefill as
    the kernel's hot spot. This is the one place the port launches a kernel
    where the reference does not."""
    q, k, v = _qkv(p, cfg, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _self_attention(q, k, v, causal=True)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.q_dim) @ p.wo, (k, v)


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor,
                     cache: Tuple[torch.Tensor, torch.Tensor],
                     pos: torch.Tensor) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); cache: one layer's (k, v), each
    (B, Smax, Hkv, D); pos: (B,) current lengths. Returns y (B, 1, d).

    Writes the new k, v **in place** into the cache at ``pos``, clamped to
    Smax - 1: the reference's ``dynamic_update_slice`` clamps the same way,
    which is what an idle slot, whose length grows past Smax, meets. The
    kernel then attends over ``pos + 1`` positions (at most Smax), reading
    the cache through a permuted view in place."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    k_cache, v_cache = cache
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(max=k_cache.shape[1] - 1).to(torch.int64)
    k_cache[rows, at] = k_new[:, 0]
    v_cache[rows, at] = v_new[:, 0]
    out = ops.gqa_decode_attention(
        q[:, 0].reshape(B, cfg.n_heads, cfg.hd),
        k_cache.permute(0, 2, 1, 3), v_cache.permute(0, 2, 1, 3), pos + 1)
    return out.reshape(B, 1, cfg.q_dim) @ p.wo


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU of the ``models.lm.FFN`` ``p``, SiLU computed in f32. (The
    reference's GELU MLP serves whisper only, which is not ported.)"""
    g = F.silu((x @ p.wg).to(torch.float32)).to(x.dtype)
    return (g * (x @ p.wi)) @ p.wo
