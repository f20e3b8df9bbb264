"""The benchmark's arithmetic: percentiles over all requests, and the
operations and bytes of the served models, reckoned from their widths
(``reference.spec.Model``) alone.

Model FLOPs count each matrix product's multiply-adds twice and
attention's two products over the positions a token attends; a prompt
runs the unembedding only at its last token (the server reads only those
logits), a decoded token at every step. A decode row's attention bytes
are what the decode kernel must move for it: the K and V of every
position it attends at every KV head, its q and its o, in bf16.
"""
from __future__ import annotations

import functools
import math
from typing import Iterable, Optional

from ..reference.spec import Model

#: published peaks of one NVIDIA H100 SXM (dense bf16; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile (the ceil(q n)-th smallest); an infinite
    value stands for a request that never got its token."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


@functools.lru_cache(maxsize=None)
def body_macs(m: Model) -> float:
    """Multiply-adds of one token through every layer's projections (the
    MoE's router and its top-k experts), the unembedding left out."""
    d, hd = m.d, m.head_dim
    total = 0.0
    for mixer, ffn in m.layers:
        if mixer == "attn":
            total += d * hd * (m.n_heads + 2 * m.n_kv_heads) \
                + m.n_heads * hd * d
        else:
            s, di = m.ssm, m.d_inner
            total += (d * 2 * di + di * s.d_conv
                      + di * (s.dt_rank + 2 * s.d_state)
                      + s.dt_rank * di + di * d)
        if ffn == "moe":
            total += d * m.moe.n_experts + m.moe.top_k * 3 * d * m.moe.d_ff
        else:
            total += 3 * d * m.d_ff
    return total


@functools.lru_cache(maxsize=None)
def scan_flops(m: Model) -> float:
    """A token's selective-scan update and read-out over every Mamba
    layer: ~6 operations per (channel, state) element."""
    if m.ssm is None:
        return 0.0
    n = sum(mx == "mamba" for mx, _ in m.layers)
    return 6.0 * n * m.d_inner * m.ssm.d_state


def attn_flops(m: Model, positions: int) -> float:
    """q k^T and p v of one token over ``positions`` in every attention
    layer."""
    return 4.0 * m.n_attn * positions * m.n_heads * m.head_dim


def prefill_flops(m: Model, L: int) -> float:
    """A prompt of L tokens, its first token read from its last row."""
    per = 2.0 * body_macs(m) + scan_flops(m)
    return (L * per + sum(attn_flops(m, p) for p in range(1, L + 1))
            + 2.0 * m.vocab * m.d)


def decode_flops(m: Model, positions: int) -> float:
    """One decoded token that attends ``positions`` positions."""
    return (2.0 * body_macs(m) + scan_flops(m) + 2.0 * m.vocab * m.d
            + attn_flops(m, positions))


def decode_attn_bytes(m: Model, positions: int) -> float:
    """What the decode kernel must move for one row over every attention
    layer: K and V at ``positions`` positions, q and o."""
    kv = 2 * positions * m.n_kv_heads * m.head_dim * BF16
    qo = 2 * m.n_heads * m.head_dim * BF16
    return float(m.n_attn * (kv + qo))


def copy_work(m: Model, L: int, j0: int, j1: int, kind: str) -> float:
    """FLOPs (``kind`` "flops") or decode-kernel bytes ("bytes") of a
    request copy's tokens j0..j1-1: token 0 is the prefill of its L-token
    prompt, token j >= 1 a decode step that attends L + j positions."""
    out = 0.0
    for j in range(j0, j1):
        if j == 0:
            out += prefill_flops(m, L) if kind == "flops" else 0.0
        elif kind == "flops":
            out += decode_flops(m, L + j)
        else:
            out += decode_attn_bytes(m, L + j)
    return out


def share(num: float, den: float) -> Optional[float]:
    """num / den in %, None where there is nothing to divide."""
    if den <= 0 or num <= 0:
        return None
    return 100.0 * num / den
