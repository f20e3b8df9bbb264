"""Plain PyTorch versions of the port's kernels.

They are the semantic ground truth: the CPU tests run them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. The main
path never calls them on a CUDA tensor.
"""
from __future__ import annotations

import torch


def dominance_matrix(F: torch.Tensor) -> torch.Tensor:
    """(P, M) objectives -> (P, P) bool, D[i, j] = i dominates j (minimize).

    Compared in f32 whatever the input type."""
    F = F.to(torch.float32)
    le = torch.all(F[:, None, :] <= F[None, :, :], dim=-1)
    lt = torch.any(F[:, None, :] < F[None, :, :], dim=-1)
    return le & lt


def dominance_counts(F: torch.Tensor) -> torch.Tensor:
    """(P,) int32: number of individuals dominating each column j."""
    return dominance_matrix(F).sum(dim=0, dtype=torch.int32)


def mha_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
    """Grouped-query attention, fully materialized.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0; query head h
    reads kv head h // (Hq // Hkv). Math in f32 (q is cast, then scaled, as
    the reference's ``ref.mha_prefill`` does); returns q's dtype."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    qf = q.to(torch.float32) * D ** -0.5
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_len: torch.Tensor) -> torch.Tensor:
    """One query token per row over a (possibly padded) KV cache.

    q: (B, Hq, D); k_cache, v_cache: (B, Hkv, Smax, D), any strides;
    kv_len: (B,) valid lengths. Positions >= kv_len are masked, so a
    ``kv_len`` past Smax attends the whole cache. The casts are the
    reference's ``ref.gqa_decode``: f32 scores scaled after the dot, softmax
    weights rounded to the cache's dtype before P·V. A row with kv_len <= 0
    gives zeros, as the TPU kernel does (the jnp oracle gives NaN there)."""
    B, Hq, D = q.shape
    Hkv, Smax = k_cache.shape[1], k_cache.shape[2]
    kv_len = kv_len.to(device=q.device, dtype=torch.int64)
    qf = q.reshape(B, Hkv, Hq // Hkv, D).to(torch.float32)
    scores = torch.einsum("bhgd,bhsd->bhgs", qf,
                          k_cache.to(torch.float32)) * D ** -0.5
    pos = torch.arange(Smax, device=q.device)
    mask = pos[None, :] < kv_len.clamp(max=Smax)[:, None]          # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    # zero weights times a non-finite V past kv_len would still give NaN
    vf = v_cache.to(torch.float32).masked_fill(~mask[:, None, :, None], 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", w.to(torch.float32),
                       vf).reshape(B, Hq, D)
    out = torch.where((kv_len > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)
