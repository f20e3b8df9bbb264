"""xLSTM blocks (arXiv:2405.04517): the counterpart of
``repro.models.xlstm``. mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential), composing xlstm-1.3b's [7:1] pattern.

mLSTM is the reference's chunkwise linear-attention form: within a chunk a
(Lc, Lc) masked score matrix, across chunks a (B, H, Dh, Dh) state C, the
normalizer n and the log-scale stabilizer m, carried by a loop over chunks.
The running max of the stabilizer is ``torch.cummax`` (a max is exact in any
order); the gate math is f32. Padding to a chunk multiple uses the
reference's state-neutral steps (log f = 0, log i = -1e30: finite, so no
``-inf - (-inf)`` can make a NaN). sLSTM keeps the sequential recurrence:
one step a token, on the host's loop. Plain torch on both devices: the
reference has no kernel here.

In a sharded serve step (the module's ``tp`` set: the 'model' axis's
region) each state leaf is the rank's block on the axis the reference's
``cache_specs`` splits (:func:`state_blocks`), and a decode step
(:func:`mlstm_step`, :func:`slstm_step`) computes on those blocks. The mLSTM
chunk is separable along C's split axis: v and C enter only the numerator
and C's update, the normalizer and the stabilizer read no C, so the rank
runs the same :func:`_mlstm_chunk` on its heads or its value columns with
n and m whole, and C is never gathered. The sLSTM state (32 KB a row)
is gathered whole for the step.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import tensor_parallel as TP
from .config import ModelConfig
from .layers import dtype_of, gelu, rms_norm
from .sharding import cache_model_axis, even_ranges

#: log input gate of padding steps and the stabilizer's initial value
NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def m_dims(cfg: ModelConfig) -> Tuple[int, int]:
    di = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    assert di % cfg.n_heads == 0
    return di, di // cfg.n_heads


def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunk. q/k/v: (B, H, Lc, Dh) f32; li/lf: (B, H, Lc) log gates.
    state: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)). Returns (h, new_state)."""
    Lc, Dh = q.shape[2], q.shape[3]
    C_prev, n_prev, m_prev = state
    Fc = torch.cumsum(lf, dim=-1)                       # inclusive
    # stabilizer: m_i = max(F_i + m_prev, max_{j<=i} (F_i - F_j + li_j))
    g_run = torch.cummax(li - Fc, dim=-1).values
    m = torch.maximum(Fc + g_run, Fc + m_prev[..., None])

    qs = q * Dh ** -0.5
    s = torch.einsum("bhid,bhjd->bhij", qs, k)          # (B, H, Lc, Lc)
    decay = (Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
             - m[..., :, None])
    mask = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    s = s * torch.where(mask, torch.exp(decay), 0.0)

    cross_scale = torch.exp(Fc + m_prev[..., None] - m)  # (B, H, Lc)
    num = (torch.einsum("bhij,bhjd->bhid", s, v)
           + torch.einsum("bhid,bhde->bhie", qs, C_prev)
           * cross_scale[..., None])
    den = (torch.sum(s, dim=-1)
           + torch.einsum("bhid,bhd->bhi", qs, n_prev) * cross_scale)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m))[..., None]

    # state update to chunk end
    FL = Fc[..., -1:]                                   # (B, H, 1)
    m_new = torch.maximum(m_prev + FL[..., 0],
                          torch.amax(FL - Fc + li, dim=-1))
    w = torch.exp(FL - Fc + li - m_new[..., None])      # (B, H, Lc)
    decay_prev = torch.exp(m_prev + FL[..., 0] - m_new)
    # w k first, whatever v's width: a block of v's columns (or of the
    # heads) gives the whole update's block to the bit at one step a chunk
    C_new = (C_prev * decay_prev[..., None, None]
             + torch.einsum("bhjd,bhje->bhde", w[..., None] * k, v))
    n_new = (n_prev * decay_prev[..., None]
             + torch.einsum("bhj,bhjd->bhd", w, k))
    return h, (C_new, n_new, m_new)


def mlstm_forward(p, cfg: ModelConfig, x: torch.Tensor, state=None):
    """The ``models.lm.MLSTM`` ``p`` over x: (B, L, d) -> (y, state),
    chunkwise over ``cfg.xlstm.chunk``; ``state`` (C, n, m) to continue
    from, or None."""
    q, k, v, li, lf, z = _mlstm_in(p, cfg, x)
    if state is None:
        state = init_mlstm_state(cfg, x.shape[0], x.device)
    h, state = _mlstm_chunks(cfg, q, k, v, li, lf, state)
    return _mlstm_out(p, cfg, h, z, x.shape[1]), state


def _mlstm_in(p, cfg: ModelConfig, x: torch.Tensor):
    """x (B, L0, d) padded to a chunk multiple L -> q, k, v (B, H, L,
    dh) f32, the log gates li, lf (B, H, L) and the output gate's z (B, L,
    di)."""
    B, L0, d = x.shape
    chunk0 = min(cfg.xlstm.chunk, L0)
    pad = (-L0) % chunk0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    L = x.shape[1]
    di, dh = m_dims(cfg)
    H = cfg.n_heads
    xi, z = torch.chunk(x @ p.up, 2, dim=-1)
    xh = xi.reshape(B, L, H, dh).to(torch.float32)

    def heads(w):   # block-diagonal projection, f32 (accum_dot's CPU path)
        return torch.einsum("blhd,hde->blhe", xh,
                            w.to(torch.float32)).transpose(1, 2)

    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)      # (B, H, L, dh)
    xf = xi.to(torch.float32)
    li = (xf @ p.wi).transpose(1, 2)                      # log input gate
    lf = F.logsigmoid(xf @ p.wf).transpose(1, 2)
    if pad:
        valid = (torch.arange(L, device=x.device) < L0)[None, None, :]
        li = torch.where(valid, li, NEG)   # no writes on pad steps
        lf = torch.where(valid, lf, 0.0)   # no decay on pad steps
    return q, k, v, li, lf, z


def _mlstm_chunks(cfg: ModelConfig, q, k, v, li, lf, state):
    """The chunk loop over L: (h (B, H, L, Dv), the state at its end)."""
    L = q.shape[2]
    Lc = min(cfg.xlstm.chunk, L)
    hs = []
    for c0 in range(0, L, Lc):
        c = slice(c0, c0 + Lc)
        h, state = _mlstm_chunk(q[:, :, c], k[:, :, c], v[:, :, c],
                                li[:, :, c], lf[:, :, c], state)
        hs.append(h)
    return torch.cat(hs, dim=2), state


def _mlstm_out(p, cfg: ModelConfig, h, z, L0: int):
    """h (B, H, L, dh) -> the block's output (B, L0, d)."""
    B, _, L, _ = h.shape
    h = h.transpose(1, 2).reshape(B, L, -1)
    h = rms_norm(p.norm, h.to(dtype_of(cfg)), cfg.norm_eps)
    y = h * F.silu(z.to(torch.float32)).to(h.dtype)
    out = y @ p.down
    return out[:, :L0] if L != L0 else out


def mlstm_step(p, cfg: ModelConfig, x: torch.Tensor, state):
    """A decode step of the ``models.lm.MLSTM`` ``p``: :func:`mlstm_forward`,
    or in a sharded step (``p.tp``) on the rank's blocks of the state
    (:func:`state_blocks`), which it returns. C splits over heads or over
    its value axis e (``einsum("bhid,bhde->bhie")``'s): the rank runs
    :func:`_mlstm_chunk` on its heads' q, k, v and gates, or on its columns
    of v, with its block of C and with n gathered whole (one all-gather;
    m is whole or already its heads' block); its block of h is gathered
    before the norm (one all-gather, with n's update on a head split). On
    a region of one rank every block is the whole tensor: the bits of
    :func:`mlstm_forward`."""
    region = getattr(p, "tp", None)
    if region is None:
        return mlstm_forward(p, cfg, x, state)
    blocks = state_blocks(cfg, region.size, region.rank)
    bC, bn = blocks["mlstm.C"], blocks["mlstm.n"]
    by_heads = bC.dim == 1
    hs = slice(bC.lo, bC.hi) if by_heads else slice(None)
    es = slice(None) if by_heads else slice(bC.lo, bC.hi)
    C, n, m = state
    q, k, v, li, lf, z = _mlstm_in(p, cfg, x)
    n = TP.gather_dim(n, -1, region)[:, hs]
    h, (C, n, m) = _mlstm_chunks(cfg, q[:, hs], k[:, hs], v[:, hs, :, es],
                                 li[:, hs], lf[:, hs], (C, n, m))
    if by_heads:        # h and n's update: the rank's heads, all of e
        L, Dh = h.shape[2:]
        whole = TP.gather_dim(torch.cat([h.flatten(2), n], -1), 1, region)
        h, n = whole[..., :-Dh].unflatten(-1, (L, Dh)), whole[..., -Dh:]
    else:               # h: every head, the rank's e
        h = TP.gather_dim(h, -1, region)
    return _mlstm_out(p, cfg, h, z, x.shape[1]), (C, TP.narrow(n, bn), m)


def init_mlstm_state(cfg: ModelConfig, batch: int, device):
    di, dh = m_dims(cfg)
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, dh, dh), **f32),
            torch.zeros((batch, H, dh), **f32),
            torch.full((batch, H), NEG, **f32))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def s_dims(cfg: ModelConfig) -> Tuple[int, int]:
    H = cfg.n_kv_heads
    assert cfg.d_model % H == 0
    return cfg.d_model, cfg.d_model // H


def slstm_forward(p, cfg: ModelConfig, x: torch.Tensor, state=None):
    """The ``models.lm.SLSTM`` ``p``: a sequential scan over time, one
    step a token. x: (B, L, d) -> (y, state (c, n, h, m))."""
    B, L, d = x.shape
    H = cfg.n_kv_heads
    dh = d // H
    pre = (x @ p.wx).to(torch.float32).reshape(B, L, 4, H, dh)
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    c, n, h, m = state

    def rec(R):
        return torch.einsum("bhd,hde->bhe", h, R)

    hs = []
    for t in range(L):
        pre_t = pre[:, t]
        z_t = torch.tanh(pre_t[:, 0] + rec(p.rz))
        i_t = pre_t[:, 1] + rec(p.ri)                    # log-space
        f_t = F.logsigmoid(pre_t[:, 2] + rec(p.rf))
        o_t = torch.sigmoid(pre_t[:, 3] + rec(p.ro))
        m_new = torch.maximum(f_t + m, i_t)
        i_e = torch.exp(i_t - m_new)
        f_e = torch.exp(f_t + m - m_new)
        c = f_e * c + i_e * z_t
        n = f_e * n + i_e
        h = o_t * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, L, d).to(x.dtype)
    y = rms_norm(p.norm, y, cfg.norm_eps)
    ff = y @ p.ff_up
    ff = gelu(ff.to(torch.float32)).to(ff.dtype)
    return ff @ p.ff_down, (c, n, h, m)


def slstm_step(p, cfg: ModelConfig, x: torch.Tensor, state):
    """A decode step of the ``models.lm.SLSTM`` ``p``:
    :func:`slstm_forward`, or in a sharded step (``p.tp``) on the rank's
    blocks of (c, n, h, m) (:func:`state_blocks`: each over dh): the four
    gathered whole in one all-gather, the step whole, the rank's blocks of
    the new state kept."""
    region = getattr(p, "tp", None)
    if region is None:
        return slstm_forward(p, cfg, x, state)
    blocks = state_blocks(cfg, region.size, region.rank)
    whole = TP.gather_dim(torch.stack(state), -1, region)
    y, state = slstm_forward(p, cfg, x, tuple(whole))
    return y, tuple(TP.narrow(t, blocks[k])
                    for k, t in zip(SLSTM_KEYS, state))


def init_slstm_state(cfg: ModelConfig, batch: int, device):
    d, dh = s_dims(cfg)
    H = cfg.n_kv_heads
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(),
            torch.full((batch, H, dh), NEG, dtype=torch.float32,
                       device=device))


# ---------------------------------------------------------------------------
# the states' blocks over 'model'
# ---------------------------------------------------------------------------

#: the state leaves, in the order the mixers return them (``lm.STATE_KEYS``)
MLSTM_KEYS = ("mlstm.C", "mlstm.n", "mlstm.m")
SLSTM_KEYS = ("slstm.c", "slstm.n", "slstm.h", "slstm.m")


@functools.lru_cache(maxsize=None)
def state_blocks(cfg: ModelConfig, n: int, r: int
                 ) -> Dict[str, Optional[TP.Block]]:
    """{state key: rank r's block of one layer's leaf (B, ...), or None
    (whole)} over a 'model' axis of n ranks, on the axis the reference's
    ``cache_specs`` splits the stacked leaf (``sharding.cache_model_axis``):
    mLSTM's C (B, H, Dh, Dh) over H where n divides it, else over its value
    axis; its n (B, H, Dh) over Dh; its m (B, H) over H, or whole; the
    sLSTM's c, n, h and m (B, H, dh) over dh, in even contiguous blocks.
    Where the rule would keep another leaf whole it raises: the states
    split exactly when the ranks share their rows, and no step holds such a
    state whole."""
    _, Dh = m_dims(cfg)
    H, dh = cfg.n_heads, s_dims(cfg)[1]
    one = {"mlstm.C": (H, Dh, Dh), "mlstm.n": (H, Dh), "mlstm.m": (H,),
           **{k: (cfg.n_kv_heads, dh) for k in SLSTM_KEYS}}
    out = {}
    for key, shape in one.items():
        stacked = (1, 1) + shape
        axis = cache_model_axis(stacked, n)
        if axis is None:
            if key != "mlstm.m":
                raise ValueError(
                    f"{cfg.name}: no axis of {key} {shape} splits over "
                    f"{n} 'model' ranks; its state cannot be laid out as "
                    f"cache_specs lays it out")
            out[key] = None
            continue
        (lo, hi), = even_ranges(stacked[axis], n)[r]
        out[key] = TP.Block(axis - 1, lo, hi)
    return out
