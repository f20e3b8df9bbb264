"""The fused decode chunk: ``n`` decode iterations with retirement on the
device, the counterpart of ``repro.serving.fleet.decode_chunk_body``.

Only the per-engine part is ported: cohorts of engines decoding as one
dispatch (``FleetState``, ``_cohort_decode_chunk``) wait for the fleet slice
(ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig


def decode_chunk_body(model: lm.LM, cfg: ModelConfig, tok: torch.Tensor,
                      cache: lm.Cache, budget: torch.Tensor,
                      alive: torch.Tensor, n: int, eos: int):
    """``n`` decode iterations with retirement on the device.

    The reference's ``lax.scan`` becomes a loop, step for step the same:
    every iteration decodes all slots, budgets drop for live slots, a live
    slot retires on an exhausted budget or EOS (its ``kv_len`` zeroes and
    its next token resets, as ``LLMEngine._release_slot`` does), and dead
    slots go on decoding what nothing reads. Nothing is read back inside
    the loop. Returns (next tokens (B, 1), cache, outs) with ``outs`` one
    stacked (n, 3, B) int32 tensor of (token, emitted, retired)."""
    outs = []
    for _ in range(n):
        logits, cache = lm.decode_step(model, cfg, tok, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emit = alive
        budget = budget - alive.to(torch.int32)
        retire = alive & ((budget <= 0) | (nxt == eos))
        alive = alive & ~retire
        cache = cache._replace(kv_len=torch.where(
            retire, torch.zeros_like(cache.kv_len), cache.kv_len))
        tok = torch.where(retire, torch.zeros_like(nxt), nxt)[:, None]
        outs.append(torch.stack([nxt, emit.to(torch.int32),
                                 retire.to(torch.int32)]))
    return tok, cache, torch.stack(outs)


class ChunkWork(NamedTuple):
    """One engine's decode chunk, ready for the host to commit."""

    outs: np.ndarray       # (n, 3, B) host array (token, emitted, retired)
    n_eff: int             # iterations to commit
    active: Sequence[int]  # slots active at dispatch time
