"""Plain PyTorch versions of the port's kernels.

They are the semantic ground truth: the CPU tests run them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. The main
path never calls them on a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 do: torch.Tensor, causal: bool = True):
    """(dq, dk, dv) of :func:`mha_prefill` at (q, k, v) for the output
    gradient ``do``: autograd of the plain version, which recomputes the
    forward (``o`` is taken for the kernel's signature and not read). The
    gradients come back in the inputs' types."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = mha_prefill(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, do)


def mha_prefill_extend(q: torch.Tensor, k_pre: torch.Tensor,
                       v_pre: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       prefix_len: Optional[int] = None) -> torch.Tensor:
    """Prefix-extension attention: suffix queries over prefix + suffix keys.

    q: (B, Hq, Sq, D) suffix queries; k_pre, v_pre: (B, Hkv, S_pre, D) the
    cached prefix; k, v: (B, Hkv, Sq, D) the suffix's own keys and values;
    any strides. Key column c of the concatenation [prefix; suffix] is
    visible to query row r iff c < prefix_len (c < S_pre) or c - S_pre <= r
    (c >= S_pre). ``prefix_len=None`` is the exact-length mode, prefix_len
    = S_pre; a smaller one is the bucketed mode, whose prefix buffer is
    padded past its real rows. The reference's ``_xla_attention`` with
    ``q_offset`` and the bucketed mask of ``attention_prefill_extend``,
    casts included: q scaled in its own dtype, f32 scores and softmax,
    weights rounded to v's dtype before P·V, the result in q's dtype. The
    prefix rows past prefix_len are masked out of P·V as well, so a
    non-finite value there cannot leak in through 0 × NaN."""
    B, Hq, Sq, D = q.shape
    Hkv, S_pre = k_pre.shape[1], k_pre.shape[2]
    group = Hq // Hkv
    plen = S_pre if prefix_len is None else int(prefix_len)
    kf = torch.cat([k_pre, k], dim=2).to(torch.float32)
    dead = torch.arange(S_pre, device=q.device) >= plen
    vh = torch.cat([v_pre.masked_fill(dead[:, None], 0), v], dim=2)
    qh = (q * D ** -0.5).reshape(B, Hkv, group, Sq, D).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kf)
    col = torch.arange(S_pre + Sq, device=q.device)[None, :]
    row = torch.arange(Sq, device=q.device)[:, None]
    mask = torch.where(col < S_pre, col < plen, (col - S_pre) <= row)
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(torch.float32),
                       vh.to(torch.float32))
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_len: torch.Tensor) -> torch.Tensor:
    """One query token per row over a (possibly padded) KV cache.

    q: (B, Hq, D); k_cache, v_cache: (B, Hkv, Smax, D), any strides;
    kv_len: (B,) valid lengths. Positions >= kv_len are masked, so a
    ``kv_len`` past Smax attends the whole cache. The casts are the
    reference's ``ref.gqa_decode``: f32 scores scaled after the dot, softmax
    weights rounded to the cache's dtype before P·V. A row with kv_len <= 0
    gives zeros, as the TPU kernel does (the jnp oracle gives NaN there)."""
    return _gqa_decode_f32(q, k_cache, v_cache, kv_len)[0].to(q.dtype)


def gqa_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, kv_len: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gqa_decode` over one block of a cache whose positions are
    split, before its rounding: (o (B, Hq, D) f32, lse (B, Hq) f32, the
    log-sum-exp of the scaled scores over the block's first kv_len
    positions). A row with kv_len <= 0 gives o = 0 and lse = -inf.
    ``tensor_parallel.merge_partials`` merges the blocks' results."""
    out, scores = _gqa_decode_f32(q, k_cache, v_cache, kv_len)
    return out, torch.logsumexp(scores, dim=-1).reshape(q.shape[:2])


def _gqa_decode_f32(q, k_cache, v_cache, kv_len):
    """(:func:`gqa_decode`'s result in f32, the masked scaled scores (B,
    Hkv, G, Smax))."""
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
    return torch.where((kv_len > 0)[:, None, None], out, 0.0), scores


def paged_gqa_decode(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over a block pool: gather the block table back into
    a contiguous cache, then :func:`gqa_decode` (the reference's
    ``ref.paged_gqa_decode``).

    q: (B, Hq, D); k_pool, v_pool: (n_blocks, Hkv, block_size, D), any
    strides (one layer of the store's (n_blocks, block_size, Hkv, D) pool
    permuted reads the same); block_table: (B, max_blocks) integer ids,
    negative ids clamped to block 0; kv_len: (B,). Positions >= kv_len are
    masked, so pad entries past it do not matter; ``kv_len <= 0`` gives
    zeros."""
    bt = block_table.to(device=q.device, dtype=torch.int64).clamp(min=0)

    def gather(pool):
        g = pool[bt]                              # (B, nb, Hkv, bs, D)
        B, nb, Hkv, bs, D = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, nb * bs, D)

    return gqa_decode(q, gather(k_pool), gather(v_pool), kv_len)
