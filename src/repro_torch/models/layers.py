"""Core layer math: the counterpart of ``repro.models.layers``.

Parameters live in the ``nn.Module``s of ``models/lm.py``; these are plain
functions on tensors. Dense weights keep the reference's (d_in, d_out)
layout, so ``x @ w`` is its ``einsum("bsd,de->bse")``. As in the reference,
norms, rope, softmax and the unembedding run in f32 and the projections in
the model's dtype. Self-attention goes through ``kernels.ops``: the plain
version for CPU tensors, the hand-written kernel for CUDA tensors.
Cross-attention over cached encoder / patch K/V is plain torch on both, as
the reference computes it outside its kernels (``_xla_attention`` with
``causal=False``), casts included; in a sharded decode step each rank
attends its block of the cached positions and the blocks' partial results
are merged. The reference's sharding constraints
(``constrain``) are not called: activations are each rank's local tensors
(``models.sharding``); the FFN runs column- then row-parallel, and
attention on the rank's heads, when its module carries a
``tensor_parallel.Region`` (``tp``): the head counts are read from the
weights' widths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import tensor_parallel as TP
from .config import ModelConfig
from .sharding import head_split


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


def embed(table: torch.Tensor, tokens: torch.Tensor,
          region: Optional[TP.Region] = None) -> torch.Tensor:
    """``table[tokens]``; in a region ``table`` is this rank's slice of
    the vocabulary's rows, a token outside it looks up zeros, and the
    lookups are summed over the group (one rank contributes each row)."""
    if region is None:
        return table[tokens]
    idx = tokens - region.rank * table.shape[0]
    own = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(own, idx, 0)]
    return TP.reduce_from(torch.where(own[..., None], rows, 0), region)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., vocab) logits in f32."""
    return x.to(torch.float32) @ table.to(torch.float32).T


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, d) @ (d, H hd) as (B, S, H, hd)."""
    return (x @ w).unflatten(-1, (-1, hd))


def _qkv(p, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor):
    """Projections of the ``models.lm.Attention`` ``p``: q (B, S, Hq, D),
    k and v (B, S, Hkv, D) (in a region the rank's heads), with qk-norm
    where the config has it."""
    q = _heads(x, p.wq, cfg.hd)
    k = _heads(kv_x, p.wk, cfg.hd)
    v = _heads(kv_x, p.wv, cfg.hd)
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
    """Full-sequence self-attention (``train_logits``); in a region
    (``p.tp``) over the rank's heads, the output summed over the
    region."""
    return attention_prefill_cache(p, cfg, x, positions, causal)[0]


def attention_prefill_cache(p, cfg: ModelConfig, x: torch.Tensor,
                            positions: torch.Tensor, causal: bool = True,
                            seq: Optional[TP.Region] = None,
                            max_seq: int = 0
                            ) -> Tuple[torch.Tensor,
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """Like ``attention``, and also returns the (k, v) cache, each (B, S,
    Hkv, D): in a region the rank's KV heads. In a sharded step (``seq``,
    the step's region) it returns instead this rank's block of a
    ``max_seq``-position cache: its positions (``TP.seq_range``) that the
    prompt reaches, at every KV head (``TP.seq_block``).

    The reference computes this with its XLA einsum path
    (``_xla_attention``); the port runs the flash kernel here, the same
    function, since the reference's kernel module itself names prefill as
    the kernel's hot spot. This is the one place the port launches a kernel
    where the reference does not."""
    region = getattr(p, "tp", None)
    x = TP.copy_to(x, region)
    q, k, v = _qkv(p, cfg, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _self_attention(q, k, v, causal)
    if seq is not None:
        k, v = TP.seq_block(k, v, region and _head_split(p, region),
                            max_seq, seq)
    return TP.reduce_from(out.flatten(2) @ p.wo, region), (k, v)


def _head_split(p, region: TP.Region):
    """The region's split of the attention module ``p``'s heads."""
    return head_split(p.heads[0], p.heads[1], region.size)


def attention_prefill_extend(p, cfg: ModelConfig, x: torch.Tensor,
                             positions: torch.Tensor,
                             prefix_kv: Tuple[torch.Tensor, torch.Tensor],
                             prefix_len: Optional[int] = None
                             ) -> Tuple[torch.Tensor,
                                        Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill the suffix of a prompt whose prefix K/V is already cached.

    x: (B, S_new, d) suffix activations; positions: (1, S_new) absolute
    positions; prefix_kv: (k, v), each (B, S_pre, Hkv, D). The suffix
    queries attend the prefix, then the suffix causally, through
    ``ops.flash_attention_extend`` (the prefix-extend variant of the flash
    kernel on the card), which reads the prefix and the suffix projections
    in place. Returns (y, (k, v)) as the reference does: the cache over
    prefix + suffix in the exact-length mode, the suffix's own K/V in the
    bucketed mode (``prefix_len`` given: only the first ``prefix_len`` rows
    of the prefix buffer are real), where the caller places it at
    ``prefix_len``."""
    k_pre, v_pre = prefix_kv
    q, k, v = _qkv(p, cfg, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention_extend(
        q.transpose(1, 2), k_pre.transpose(1, 2), v_pre.transpose(1, 2),
        k.transpose(1, 2), v.transpose(1, 2), prefix_len).transpose(1, 2)
    B, S = x.shape[:2]
    y = out.reshape(B, S, cfg.q_dim) @ p.wo
    if prefix_len is None:
        return y, (torch.cat([k_pre, k], dim=1), torch.cat([v_pre, v], dim=1))
    return y, (k, v)


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor,
                     cache: Tuple[torch.Tensor, torch.Tensor],
                     pos: torch.Tensor, seq: Optional[TP.Region] = None,
                     max_seq: int = 0) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); cache: one layer's (k, v), each
    (B, Smax, Hkv, D); pos: (B,) current lengths. Returns y (B, 1, d), in
    a region (``p.tp``) summed over it.

    Writes the new k, v **in place** into the cache at ``pos``, clamped to
    Smax - 1: the reference's ``dynamic_update_slice`` clamps the same way,
    which is what an idle slot, whose length grows past Smax, meets. The
    kernel then attends over ``pos + 1`` positions (at most Smax), reading
    the cache through a permuted view in place.

    In a sharded step (``seq``, the step's region) the cache holds this
    rank's positions [lo, hi) of a ``max_seq``-position cache at every KV
    head (``TP.seq_range``), as the reference's ``cache_specs`` lays it
    out: see :func:`_decode_split`."""
    region = getattr(p, "tp", None)
    x = TP.copy_to(x, region)
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    if seq is not None:
        out = _decode_split(p, q[:, 0], k_new[:, 0], v_new[:, 0], cache, pos,
                            seq, max_seq)
        return TP.reduce_from(out.reshape(B, 1, -1) @ p.wo, region)
    k_cache, v_cache = cache
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(max=k_cache.shape[1] - 1).to(torch.int64)
    k_cache[rows, at] = k_new[:, 0]
    v_cache[rows, at] = v_new[:, 0]
    out = ops.gqa_decode_attention(
        q[:, 0], k_cache.permute(0, 2, 1, 3), v_cache.permute(0, 2, 1, 3),
        pos + 1)
    return TP.reduce_from(out.reshape(B, 1, -1) @ p.wo, region)


def _decode_split(p, q, k_new, v_new, cache, pos, seq: TP.Region,
                  max_seq: int) -> torch.Tensor:
    """Split-sequence decode attention of q (B, H_r, D) and the new k, v
    (B, Hkv_r, D) at the rank's heads (all of them outside a region)
    over a cache whose positions split over ``seq``: q, k and v gathered
    whole (``TP.gather_heads``); the rank whose block holds ``pos``
    (clamped to max_seq - 1) writes k and v there, the others write
    nothing; the decode kernel's partial mode over the block for every
    query head, with kv_len ``pos + 1 - lo`` clamped to the block; the
    ranks' (o, lse) merged (``TP.merge_partials``). Returns the rank's
    query heads' (B, H_r, D) in q's dtype."""
    region = getattr(p, "tp", None)
    heads = region and _head_split(p, region)
    if heads is not None:
        q, k_new, v_new = TP.gather_heads(q, k_new, v_new, heads, region)
    k_cache, v_cache = cache
    lo, hi = TP.seq_range(max_seq, seq)
    B, n = q.shape[0], hi - lo
    if n:
        rows = torch.arange(B, device=q.device)
        at = pos.to(torch.int64) - lo
        other = ~((at >= 0) & ((at < n) | (hi == max_seq)))[:, None, None]
        at = at.clamp(0, n - 1)
        k_cache[rows, at] = torch.where(other, k_cache[rows, at], k_new)
        v_cache[rows, at] = torch.where(other, v_cache[rows, at], v_new)
        o, lse = ops.gqa_decode_partial(
            q, k_cache.permute(0, 2, 1, 3), v_cache.permute(0, 2, 1, 3),
            (pos + 1 - lo).clamp(0, n))
    else:           # a block of no positions (max_seq < the region's size)
        o = q.new_zeros(q.shape, dtype=torch.float32)
        lse = o.new_full(q.shape[:2], float("-inf"))
    out = TP.merge_partials(o, lse, seq).to(q.dtype)
    if heads is not None:
        a, b = heads.q[region.rank]
        out = out[:, a:b]
    return out


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder, llama-3.2-vision)
# ---------------------------------------------------------------------------

def _plain_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Non-causal GQA over (B, S, H, D) inputs, (B, Sq, Hq, D) out: the
    reference's ``_xla_attention(causal=False)``, casts included (q scaled
    in its own dtype, f32 scores and softmax, the weights rounded to v's
    dtype before P·V, the result in q's dtype)."""
    return _attention_partial(q, k, v, lse=False)[0].to(q.dtype)


def _attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lse: bool = True):
    """:func:`_plain_attention` before its cast to q's dtype: (out (B, Sq,
    Hq, D) f32, the scores' log-sum-exp (B, Sq, Hq) f32, or None without
    ``lse``). Over a block of the positions it is that block's partial
    result for ``tensor_parallel.merge``: one block gives
    ``_plain_attention``'s bits after the cast."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qh = (q.transpose(1, 2) * D ** -0.5).reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh.to(torch.float32),
                     k.transpose(1, 2).to(torch.float32))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(torch.float32),
                       v.transpose(1, 2).to(torch.float32))
    return (out.reshape(B, Hq, Sq, D).transpose(1, 2),
            torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq).transpose(1, 2)
            if lse else None)


def cross_kv(p, cfg: ModelConfig, kv_x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V, each (B, T, Hkv, D) (in a region the rank's KV
    heads), from encoder output or patch embeddings (B, T, d). bf16
    patches into an f32 model are widened first (exact), as JAX promotes
    them."""
    kv_x = TP.copy_to(kv_x.to(p.wk.dtype), getattr(p, "tp", None))
    k = _heads(kv_x, p.wk, cfg.hd)
    v = _heads(kv_x, p.wv, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(p.knorm, k, cfg.norm_eps)
    return k, v


def cross_attention_cached(p, cfg: ModelConfig, x: torch.Tensor,
                           kv: Tuple[torch.Tensor, torch.Tensor],
                           seq: Optional[TP.Region] = None) -> torch.Tensor:
    """x (B, S, d) attends all of the cached (k, v), each (B, T, Hkv, D);
    no rope. Returns (B, S, d); in a region over the rank's heads (``kv``
    from ``cross_kv`` in the same region), summed over it.

    In a sharded decode step (``seq``, the step's region) ``kv`` is the
    rank's block of the T positions at every KV head (:func:`cross_block`):
    q is gathered whole over the region (``TP.gather_query``), every rank
    attends its block for all query heads (:func:`_attention_partial`),
    the ranks' (o, lse) are merged (``TP.merge_partials``), and the rank's
    query heads go through its rows of ``wo``."""
    region = getattr(p, "tp", None)
    q = _heads(TP.copy_to(x, region), p.wq, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(p.qnorm, q, cfg.norm_eps)
    if seq is None:
        out = _plain_attention(q, *kv)
    else:
        heads = region and _head_split(p, region)
        if heads is not None:
            q = TP.gather_query(q, heads, region)
        out = TP.merge_partials(*_attention_partial(q, *kv), seq
                                ).to(q.dtype)
        if heads is not None:
            a, b = heads.q[region.rank]
            out = out[:, :, a:b]
    return TP.reduce_from(out.flatten(2) @ p.wo, region)


def cross_block(p, kv: Tuple[torch.Tensor, torch.Tensor],
                seq: Optional[TP.Region]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a cache keeps of the cross K/V that :func:`cross_kv` computed
    for the module ``p``, each (B, T, Hkv_r, D): all of it, or in a sharded
    step (``seq``) every KV head at the rank's positions of T
    (``TP.seq_block`` with T as the cache's depth: one all-to-all where
    the KV heads split, else a slice)."""
    if seq is None:
        return kv
    region = getattr(p, "tp", None)
    return TP.seq_block(*kv, region and _head_split(p, region),
                        kv[0].shape[1], seq)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def ffn_apply(p, x: torch.Tensor, activation: str = "swiglu"
              ) -> torch.Tensor:
    """The ``models.lm.FFN`` ``p``: SwiGLU, or the GELU MLP (whisper), the
    activation computed in f32. In a region (``p.tp``) ``wi`` / ``wg`` are
    this rank's columns and ``wo`` its rows: the output is summed over the
    region."""
    region = getattr(p, "tp", None)
    x = TP.copy_to(x, region)
    h = x @ p.wi
    if activation == "swiglu":
        h = F.silu((x @ p.wg).to(torch.float32)).to(x.dtype) * h
    else:
        h = gelu(h.to(torch.float32)).to(x.dtype)
    return TP.reduce_from(h @ p.wo, region)
