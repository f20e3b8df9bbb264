"""Mamba selective-SSM block (for the Jamba hybrid): the counterpart of
``repro.models.ssm``.

The recurrence h_t = a_t ⊙ h_{t-1} + b_t (a_t = exp(Δ_t·A)) runs chunkwise
as in the reference: a Python loop over chunks of ``cfg.ssm.chunk`` tokens
carries the (B, d_inner, d_state) boundary state, and inside a chunk
:func:`associative_scan` combines the steps in the tree order of
``jax.lax.associative_scan``, so the f32 sums are grouped as the
reference's. A prompt is padded to a chunk multiple with state-neutral
steps (Δt = 0, so a = 1 and b = 0), which leaves the state exact at its
last real position. Decode is the same forward at L = 1 on the state
(h, conv window). Plain torch on both devices: the reference has no kernel
here.

In a region (``p.tp``, a ``tensor_parallel.Region``) the module's weights
are the rank's d_inner / n channels: every per-channel step (in_proj's
two halves, the conv, Δt, the scan and its state) runs on them locally;
``x_proj``'s rows are the rank's, its outputs summed over the region;
``out_proj``'s rows too, the block's output summed over the region. A
decode cache then holds the state of the rank's channels
(:func:`init_state`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import tensor_parallel as TP
from .config import ModelConfig

State = Tuple[torch.Tensor, torch.Tensor]


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def _sl(e: torch.Tensor, dim: int, start, stop=None, step=1):
    return e[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (len(a) = len(b) or one
    more)."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     dim: int) -> list:
    """Inclusive scan of ``fn`` (earlier, later) -> combined over ``dim``,
    evaluated in ``jax.lax.associative_scan``'s order: adjacent pairs
    combined, the half-length scan recursively, then the even positions
    fixed up from the odd ones; O(log L) vectorized steps."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    reduced = fn([_sl(e, dim, 0, n - 1, 2) for e in elems],
                 [_sl(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([_sl(e, dim, 0, -1) for e in odd],
                  [_sl(e, dim, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_sl(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_sl(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return [a1 * a2, a2 * b1 + b2]


def _scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t over dim 1, chunked. a, b: (B, L, di,
    ds). Returns (h at L, states at every t)."""
    h, hs = h0, []
    for c0 in range(0, a.shape[1], chunk):
        A_cum, B_cum = associative_scan(
            _combine, (a[:, c0:c0 + chunk], b[:, c0:c0 + chunk]), 1)
        st = A_cum * h[:, None] + B_cum
        hs.append(st)
        h = st[:, -1]
    return h, torch.cat(hs, dim=1)


def _ssm_params(p, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (B, L, di) post-conv activations -> (dtv, Bv, Cv) f32 (in a
    region: xc and dtv the rank's channels; the x_proj sums over every
    channel)."""
    ds, dr = cfg.ssm.d_state, dt_rank(cfg)
    region = getattr(p, "tp", None)
    proj = TP.copy_to(TP.reduce_from((xc @ p.x_proj).to(torch.float32),
                                     region), region)
    dt_in, Bv, Cv = torch.split(proj, [dr, ds, ds], dim=-1)
    pre = dt_in @ p.dt_proj_w.to(torch.float32) + p.dt_proj_b
    dtv = torch.logaddexp(pre, torch.zeros_like(pre))     # jax's softplus
    return dtv, Bv, Cv


def mamba_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  state: State = None) -> Tuple[torch.Tensor, State]:
    """Full-sequence forward of the ``models.lm.Mamba`` ``p``. x: (B, L,
    d); ``state`` (h (B, di, ds) f32, conv window (B, d_conv - 1, di)) to
    continue from, or None. Returns (y, (h, conv window)) at position L."""
    s = cfg.ssm
    region = getattr(p, "tp", None)
    x = TP.copy_to(x, region)
    B, L0, _ = x.shape
    chunk0 = min(s.chunk, L0)
    pad = (-L0) % chunk0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    L = x.shape[1]
    xi, z = torch.chunk(x @ p.in_proj, 2, dim=-1)          # (B, L, di)

    # causal depthwise conv (window d_conv), summed in the reference's order
    if state is not None:
        xpad = torch.cat([state[1], xi], dim=1)
    else:
        xpad = F.pad(xi, (0, 0, s.d_conv - 1, 0))
    xc = xpad[:, 0:L] * p.conv_w[0]
    for i in range(1, s.d_conv):
        xc = xc + xpad[:, i:i + L] * p.conv_w[i]
    xc = F.silu((xc + p.conv_b).to(torch.float32)).to(x.dtype)
    new_conv_win = xpad[:, L0:L0 + s.d_conv - 1]

    dtv, Bv, Cv = _ssm_params(p, cfg, xc)
    if pad:
        valid = (torch.arange(L, device=x.device) < L0)[None, :, None]
        dtv = torch.where(valid, dtv, 0.0)                  # a=1, b=0 on pad
    A = -torch.exp(p.A_log)                                 # (di, ds)
    a = torch.exp(dtv[..., None] * A)                       # (B, L, di, ds)
    bterm = (dtv * xc.to(torch.float32))[..., None] * Bv[:, :, None, :]

    h0 = (state[0] if state is not None else
          torch.zeros((B, xc.shape[-1], s.d_state), dtype=torch.float32,
                      device=x.device))
    h_last, hs = _scan_chunked(a, bterm, h0, min(s.chunk, L))

    y = torch.einsum("blds,bls->bld", hs, Cv) + p.D * xc.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = TP.reduce_from(y @ p.out_proj, region)
    if pad:
        out = out[:, :L0]
    return out, (h_last, new_conv_win)


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """One-token step. x: (B, 1, d); state: (h (B, di, ds), conv_win)."""
    return mamba_forward(p, cfg, x, state=state)


def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device, channels: Optional[int] = None) -> State:
    """The zero state (h, conv window) of ``channels`` channels (default
    all d_inner; in a region the rank's)."""
    s = cfg.ssm
    di = d_inner(cfg) if channels is None else channels
    return (torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, s.d_conv - 1, di), dtype=dtype,
                        device=device))
