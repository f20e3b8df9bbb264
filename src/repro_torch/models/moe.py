"""Token-choice top-k Mixture-of-Experts with capacity: the counterpart of
``repro.models.moe``.

The reference's sort-based dispatch, step for step:

  1. router top-k -> (T, k) expert ids + renormalized weights,
  2. the flat (T·k,) expert ids sorted stably -> tokens grouped by expert,
  3. each assignment's position within its expert from the sorted order;
     positions >= capacity C are dropped,
  4. tokens gathered into an (E, C, d) buffer, batched expert GEMMs
     (``torch.bmm``),
  5. combine: each token's (expert, slot) output times its router weight.

C = max(8, ceil(T·k·capacity_factor / E)) rounded up to a multiple of 8.
Capacity couples the rows of a batch: which assignments drop depends on
every token of the call, idle engine rows included, so the serving engine
neither pads MoE prompts nor decodes MoE engines as a fleet cohort.

Tie order is the reference's: ``jax.lax.top_k`` takes the lower expert id
among equal probabilities, which a stable descending sort gives, and the
dispatch sort is stable (``jnp.argsort``). All plain torch on both devices:
the reference has no kernel here.

Expert parallelism: when the module carries a ``tensor_parallel.Region``
(``tp``), its expert weights are this rank's E / size experts. Routing,
the aux loss and the dispatch run alike on every rank (the tokens are the
same on each); a rank runs the GEMMs of its experts' slice of the (E, C,
d) buffer, the outputs are all-gathered into (E, C, d), and the combine
runs as without a region, in the same order: drops and routing are those
of the whole layer.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import tensor_parallel as TP
from .config import ModelConfig

#: when a list, every ``moe_apply`` appends its (T, k) expert choices and
#: its count of dropped (token, choice) assignments, a 0-d tensor (read
#: them after the pass: appending does not wait for the device)
ROUTING: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss) with the ``models.lm.MoE`` ``p``. The
    load-balancing aux loss is the Switch/GShard  E · Σ_e f_e · p_e  term."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    dev = x.device

    logits = xt.to(torch.float32) @ p.router                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)                               # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # aux loss (fraction routed vs router prob mass); the one-hot by
    # comparison, which (unlike F.one_hot and bincount) never waits for the
    # device to check its indices
    one_hot = (top_e[..., None] == torch.arange(E, device=dev)).to(
        torch.float32)                                           # (T, k, E)
    f = torch.mean(one_hot.sum(dim=1), dim=0)                    # (E,)
    aux = E * torch.sum(f * torch.mean(probs, dim=0))

    # ---- sort-based dispatch ------------------------------------------------
    flat_e = top_e.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = one_hot.sum(dim=(0, 1)).to(torch.int64)             # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos_sorted < C
    if ROUTING is not None:
        ROUTING.append((top_e, (~keep).sum()))
    # (expert, slot) <- flat token index; empty slots point at row T (zeros);
    # dropped assignments all land on a spare last entry, cut off after
    slot_token = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    dst = torch.where(keep, sorted_e * C + pos_sorted, E * C)
    slot_token[dst] = torch.div(order, k, rounding_mode="floor")
    slot_token = slot_token[:E * C].reshape(E, C)

    # this rank's experts [lo, lo + n) (all of them outside a region)
    region = getattr(p, "tp", None)
    n = p.wi.shape[0]
    lo = 0 if region is None else region.rank * n
    xt_e = TP.copy_to(xt, region)
    xpad = torch.cat([xt_e, xt_e.new_zeros((1, d))], dim=0)
    xe = xpad[slot_token[lo:lo + n]]                             # (n, C, d)

    # ---- expert GEMMs --------------------------------------------------------
    h = torch.bmm(xe, p.wi)
    g = torch.bmm(xe, p.wg)
    h = F.silu(g.to(torch.float32)).to(h.dtype) * h
    ye = TP.gather(torch.bmm(h, p.wo), region)                   # (E, C, d)

    # ---- combine -------------------------------------------------------------
    # the k-th choice of a token sits at (expert top_e, slot); slot C (a row
    # of zeros) marks a dropped assignment
    slot_flat = torch.empty(T * k, dtype=torch.int64, device=dev)
    slot_flat[order] = torch.where(keep, pos_sorted, C)
    slot = slot_flat.reshape(T, k)
    ypad = torch.cat([ye, ye.new_zeros((E, 1, d))], dim=1)
    gathered = ypad[top_e, slot]                                 # (T, k, d)
    y = torch.sum(gathered.to(torch.float32) * top_w[..., None],
                  dim=1).to(x.dtype)
    return y.reshape(B, S, d), aux
