"""The dense language model: the counterpart of ``repro.models.lm`` for the
``(("attn", "dense"),)`` pattern.

The reference keeps parameters in a pytree stacked over periods and scans
over them; here each layer is an ``nn.Module`` in a ``ModuleList`` and the
forward passes are Python loops over layers. Shapes, initial scales and
dtypes are the reference's (f32 norm gains, weights in the config's dtype),
and ``convert.lm_params_from_numpy`` carries a reference ``lm.init`` pytree
over exactly.

Public entry points:
    init(cfg, generator, device)                     -> LM
    train_logits(model, cfg, tokens)                 -> (B, S, vocab) f32
    prefill(model, cfg, tokens, max_seq, length)     -> (last logits, Cache)
    make_cache(cfg, batch, max_seq, device)          -> empty Cache
    decode_step(model, cfg, token, cache)            -> (logits, Cache)

Any other block pattern raises ``NotImplementedError``: MoE, SSM, xLSTM and
the cross-attention families are ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from .._device import Device, resolve
from . import layers as L
from .config import ModelConfig

DENSE = (("attn", "dense"),)


class Cache(NamedTuple):
    """Decode state. ``k`` and ``v`` are stacked over layers,
    (n_layers, B, Smax, Hkv, D), as the reference stacks them over periods;
    ``kv_len`` (B,) int32 is each row's fill. ``decode_step`` writes into
    ``k`` and ``v`` in place. (The reference's shared ``pos`` cursor is not
    kept: no dense path reads it.)"""
    k: torch.Tensor
    v: torch.Tensor
    kv_len: torch.Tensor


def check_dense(cfg: ModelConfig) -> None:
    if (tuple(cfg.pattern) != DENSE or cfg.family in ("audio", "vlm")
            or cfg.activation != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: pattern {cfg.pattern} ({cfg.family}, "
            f"{cfg.activation}) is not ported; the port runs dense SwiGLU "
            f"{DENSE} models (the others are ROADMAP Queue 1 item 12)")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.g = _param((d,), torch.float32, device)
        self.b = (_param((d,), torch.float32, device)
                  if cfg.norm == "layernorm" else None)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, d = L.dtype_of(cfg), cfg.d_model
        self.wq = _param((d, cfg.q_dim), dt, device)
        self.wk = _param((d, cfg.kv_dim), dt, device)
        self.wv = _param((d, cfg.kv_dim), dt, device)
        self.wo = _param((cfg.q_dim, d), dt, device)
        self.qnorm = (_param((cfg.hd,), torch.float32, device)
                      if cfg.qk_norm else None)
        self.knorm = (_param((cfg.hd,), torch.float32, device)
                      if cfg.qk_norm else None)


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, d, ff = L.dtype_of(cfg), cfg.d_model, cfg.d_ff
        self.wi = _param((d, ff), dt, device)
        self.wg = _param((d, ff), dt, device)
        self.wo = _param((ff, d), dt, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.mixer = Attention(cfg, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.ffn = FFN(cfg, device)


class LM(nn.Module):
    """Parameters of a dense LM, allocated uninitialized on ``device``
    (fill them with ``init`` or ``convert.lm_params_from_numpy``)."""

    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        check_dense(cfg)
        dev = resolve(device)
        dt = L.dtype_of(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, dev)
        self.head = (None if cfg.tie_embeddings
                     else _param((cfg.vocab, cfg.d_model), dt, dev))
        self.final_norm = Norm(cfg, cfg.d_model, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_table(self) -> torch.Tensor:
        return self.embed if self.head is None else self.head


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator,
         device: Device = None) -> LM:
    """Random weights with the reference's scales: normal · 1/sqrt(d_in)
    for dense weights, normal · 0.02 for the embedding and the head, ones
    (and zeros) for norms. Draws are made in f32 on the generator's device,
    then cast and moved; the same generator state gives the same model."""
    model = LM(cfg, device)

    def fill(p: Optional[torch.Tensor], scale: float) -> None:
        if p is None:
            return
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        p.copy_((x * scale).to(p.dtype))

    fill(model.embed, 0.02)
    fill(model.head, 0.02)
    for norm in model.modules():
        if isinstance(norm, Norm):
            norm.g.fill_(1.0)
            if norm.b is not None:
                norm.b.zero_()
    for blk in model.blocks:
        a, f = blk.mixer, blk.ffn
        for w in (a.wq, a.wk, a.wv, a.wo, f.wi, f.wg, f.wo):
            fill(w, 1.0 / math.sqrt(w.shape[0]))
        for g in (a.qnorm, a.knorm):
            if g is not None:
                g.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _final_logits(model: LM, cfg: ModelConfig, x: torch.Tensor):
    return L.unembed(model.head_table(), L.apply_norm(cfg, model.final_norm,
                                                      x))


def _ffn(blk: Block, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + L.ffn_apply(blk.ffn, L.apply_norm(cfg, blk.norm2, x))


def train_logits(model: LM, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens -> (B, S, vocab) f32 logits, causal. Forward only."""
    check_dense(cfg)
    x = L.embed(model.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for blk in model.blocks:
        x = x + L.attention(blk.mixer, cfg, L.apply_norm(cfg, blk.norm1, x),
                            positions=positions, causal=True)
        x = _ffn(blk, cfg, x)
    return _final_logits(model, cfg, x)


def make_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device: Device = None,
               kv_len: Optional[torch.Tensor] = None) -> Cache:
    """An empty decode cache (zeros), with ``kv_len`` marking the fill."""
    check_dense(cfg)
    dev = resolve(device)
    shp = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = L.dtype_of(cfg)
    if kv_len is None:
        kv_len = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    return Cache(k=torch.zeros(shp, dtype=dt, device=dev),
                 v=torch.zeros(shp, dtype=dt, device=dev),
                 kv_len=kv_len.to(device=dev, dtype=torch.int32))


def prefill(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: Optional[int] = None,
            length: Optional[int] = None):
    """Run the prompt (B, S); return (last-token logits (B, vocab) f32,
    Cache allocated at ``max_seq`` (default S) holding the prompt's K/V).

    ``length`` is **bucketed prefill**: the tokens may be padded past the
    real prompt, logits are read at row ``length - 1`` and ``kv_len`` marks
    only the real prompt, so the padded tail cannot reach any output (causal
    masking keeps rows independent in a dense model)."""
    check_dense(cfg)
    B, S = tokens.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    fill = S if length is None else int(length)
    cache = make_cache(cfg, B, max_seq, tokens.device,
                       kv_len=torch.full((B,), fill, dtype=torch.int32))
    x = L.embed(model.embed, tokens)
    positions = torch.arange(S, device=tokens.device)[None]
    for li, blk in enumerate(model.blocks):
        y, (k, v) = L.attention_prefill_cache(
            blk.mixer, cfg, L.apply_norm(cfg, blk.norm1, x), positions)
        cache.k[li, :, :S] = k
        cache.v[li, :, :S] = v
        x = _ffn(blk, cfg, x + y)
    logits = _final_logits(model, cfg, x[:, fill - 1:fill])[:, 0]
    return logits, cache


def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache):
    """token: (B, 1) -> (logits (B, vocab) f32, Cache). Every row decodes,
    live or not, and every row's kv_len grows by one, as in the reference;
    the K/V buffers are updated in place and returned in the new Cache."""
    x = L.embed(model.embed, token)
    for li, blk in enumerate(model.blocks):
        x = x + L.attention_decode(blk.mixer, cfg,
                                   L.apply_norm(cfg, blk.norm1, x),
                                   (cache.k[li], cache.v[li]), cache.kv_len)
        x = _ffn(blk, cfg, x)
    logits = _final_logits(model, cfg, x)[:, 0]
    return logits, cache._replace(kv_len=cache.kv_len + 1)

