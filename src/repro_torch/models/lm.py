"""The language-model zoo: the counterpart of ``repro.models.lm``, one LM
for every block pattern of the config (dense / MoE / SSM / xLSTM / hybrid /
encoder-decoder / VLM).

The reference keeps parameters in a pytree stacked over periods and scans
over them; here each layer is an ``nn.Module`` in a ``ModuleList`` and the
passes are Python loops over layers. Shapes, initial scales and dtypes are
the reference's, and ``convert.lm_params_from_numpy`` carries a reference
``lm.init`` pytree over exactly (each module's ``REF`` names its leaves).

Public entry points:
    init(cfg, generator, device)                     -> LM
    train_logits(model, cfg, tokens, frames, patches, remat, remat_policy)
                                                     -> ((B, S, vocab) f32,
                                                         MoE aux loss)
    loss_fn(model, cfg, batch, remat, aux_weight, remat_policy)
                                                     -> (loss, {nll, aux})
    prefill(model, cfg, tokens, max_seq, length, frames, patches,
            materialize)                             -> (last logits, Cache)
    prefill_extend(model, cfg, tokens, prefix, max_seq, prefix_len, length)
                                                     -> (last logits, Cache)
    make_cache(cfg, batch, max_seq, device, tp=)     -> empty Cache
    decode_step(model, cfg, token, cache, materialize)
                                                     -> (logits, Cache)
    param_stacks(cfg, names)                         -> {stack: [names]}

``frames`` (audio: (B, T, d) stub-frontend embeddings through the encoder)
and ``patches`` (vlm: (B, T, d) patch embeddings) feed cross-attention; they
are bf16 or the model's dtype. An unknown mixer raises ``ValueError``, as
in the reference.

Parameters are built with ``requires_grad=False``, so no serving path
records a graph; training asks for gradients with ``model.requires_grad_()``
(``training.trainer``). ``train_logits`` then wraps each period of the block
pattern in activation checkpointing (``torch.utils.checkpoint``), as the
reference wraps its scan body in ``jax.checkpoint``, with the reference's
remat policies (``REMAT_POLICIES``).

The modules with ``SPLIT`` (the LM's embedding and head, ``FFN``, ``MoE``,
``Attention``, ``Mamba``) are the 'model'-parallel regions of
``tensor_parallel``: a sharded trainer or server sets their ``tp`` for a
step, and ``SPLIT`` names the dimension of each weight that a rank then
holds a block of (``split_ranges``, where a module has it, which ranges of
it: attention's heads, Mamba's channels). ``prefill`` and ``decode_step``
run in those regions too: the cache then holds its leaves as the
reference's ``cache_specs`` lays them out (``make_cache(tp=)``): the self-
and cross-attention K/V every KV head at the rank's positions, the Mamba
state at its channels, the xLSTM states in their blocks (the region set on
the ``MLSTM`` / ``SLSTM`` modules by a sharded server whose batch rows the
'model' ranks share); the last logits are gathered whole over the
vocabulary. ``prefill_extend`` (the engine's prefix
reuse) runs on one card only.
"""
from __future__ import annotations

import functools
import math
from types import MappingProxyType
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import Device, resolve
from . import layers as L
from . import moe as M
from . import sharding as SH
from . import ssm as S
from . import tensor_parallel as TP
from . import xlstm as X
from .config import ModelConfig

SELF_ATTN = ("attn", "attn_bidir", "attn_cross")
#: the Cache.state leaves of each state group, in the order the mixers
#: return them; each leaf is stacked over the group's layers: (n, B, ...)
STATE_KEYS = {"mamba": ("mamba.h", "mamba.conv"),
              "mlstm": X.MLSTM_KEYS, "slstm": X.SLSTM_KEYS,
              "cross": ("cross.k", "cross.v")}
_EMPTY: Mapping[str, torch.Tensor] = MappingProxyType({})


class Cache(NamedTuple):
    """Decode state. ``k`` and ``v`` are stacked over the self-attention
    layers, (n_attn, B, Smax, Hkv, D): for a dense model every layer, as the
    reference stacks them over periods; ``kv_len`` (B,) int32 is each row's
    fill. ``state`` holds the rest, each leaf stacked over its group's
    layers with the batch on dim 1 like ``k``: the Mamba state (h (n, B,
    di, ds) f32, conv window (n, B, d_conv - 1, di)), the mLSTM state (C
    (n, B, H, Dh, Dh), n, m, f32), the sLSTM state (c, n, h, m, each (n, B,
    H, dh) f32) and the cross-attention K/V ((n, B, T, Hkv, D)), under the
    keys of ``STATE_KEYS``. ``decode_step`` writes into ``k``, ``v`` and the
    recurrent state in place. (The reference's shared ``pos`` cursor is not
    kept: no path reads it.) ``max_seq`` is None where ``k`` and ``v`` hold
    every position; in a sharded step (``make_cache(tp=)``) it is the
    cache's positions, of which they hold the rank's block
    (``tensor_parallel.seq_range``)."""
    k: torch.Tensor
    v: torch.Tensor
    kv_len: torch.Tensor
    state: Mapping[str, torch.Tensor] = _EMPTY
    max_seq: Optional[int] = None


class Layer(NamedTuple):
    mixer: str
    ffn: str
    attn: int     # index into Cache.k / v, or -1
    group: str    # STATE_KEYS group of the layer's state ("" for none)
    slot: int     # index within that group's stack, or -1


@functools.lru_cache(maxsize=None)
def layout(cfg: ModelConfig) -> Tuple[Layer, ...]:
    """Each layer's mixer, ffn and places in the Cache."""
    counts: Dict[str, int] = {"attn": 0}
    out = []
    for li in range(cfg.n_layers):
        mixer, ffn = cfg.block_at(li)
        ai = -1
        if mixer in SELF_ATTN:
            ai = counts["attn"]
            counts["attn"] += 1
        group = ("cross" if mixer in ("cross", "attn_cross") else
                 mixer if mixer in ("mamba", "mlstm", "slstm") else "")
        slot = -1
        if group:
            slot = counts.get(group, 0)
            counts[group] = slot + 1
        out.append(Layer(mixer, ffn, ai, group, slot))
    return tuple(out)


def n_attn(cfg: ModelConfig) -> int:
    """Self-attention layers of the decoder (the K/V cache's depth)."""
    return sum(layer.attn >= 0 for layer in layout(cfg))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Norm(nn.Module):
    REF = {"g": ("g",), "b": ("b",)}

    def __init__(self, d: int, layernorm: bool, device):
        super().__init__()
        self.g = _param((d,), torch.float32, device)
        self.b = _param((d,), torch.float32, device) if layernorm else None

    def reset_constants(self) -> None:
        self.g.fill_(1.0)
        if self.b is not None:
            self.b.zero_()


def _norm(cfg: ModelConfig, device) -> Norm:
    return Norm(cfg.d_model, cfg.norm == "layernorm", device)


class Attention(nn.Module):
    """Self- or cross-attention projections (the reference's
    ``attn_init``, the same for both). In a region a rank holds the
    columns of its query heads (``wq``), of the KV heads they read
    (``wk``, ``wv``) and the rows of its query heads (``wo``); the
    qk-norm gains act on its heads."""
    RANDOM = ("wq", "wk", "wv", "wo")
    REF = {"wq": ("wq", "w"), "wk": ("wk", "w"), "wv": ("wv", "w"),
           "wo": ("wo", "w"), "qnorm": ("qnorm", "g"),
           "knorm": ("knorm", "g")}
    SPLIT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}     # by heads
    PARTIAL = ("qnorm", "knorm")
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        dt, d = L.dtype_of(cfg), cfg.d_model
        self.wq = _param((d, cfg.q_dim), dt, device)
        self.wk = _param((d, cfg.kv_dim), dt, device)
        self.wv = _param((d, cfg.kv_dim), dt, device)
        self.wo = _param((cfg.q_dim, d), dt, device)
        self.qnorm = (_param((cfg.hd,), torch.float32, device)
                      if cfg.qk_norm else None)
        self.knorm = (_param((cfg.hd,), torch.float32, device)
                      if cfg.qk_norm else None)

    def reset_constants(self) -> None:
        for g in (self.qnorm, self.knorm):
            if g is not None:
                g.fill_(1.0)

    def split_ranges(self, n: int):
        """Each rank's columns of wq / wk / wv and rows of wo over n
        ranks (``sharding.head_split``), or None (kept whole)."""
        H, Hkv, hd = self.heads
        heads = SH.head_split(H, Hkv, n)
        if heads is None:
            return None
        q, kv = ([((a * hd, b * hd),) for a, b in part] for part in heads)
        return {"wq": q, "wk": kv, "wv": kv, "wo": q}


class FFN(nn.Module):
    """SwiGLU (``wg`` the gate), or the GELU MLP (no ``wg``)."""
    RANDOM = ("wi", "wg", "wo")
    REF = {"wi": ("wi", "w"), "wg": ("wg", "w"), "wo": ("wo", "w")}
    SPLIT = {"wi": 1, "wg": 1, "wo": 0}     # column-, then row-parallel
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, d, ff = L.dtype_of(cfg), cfg.d_model, cfg.d_ff
        self.wi = _param((d, ff), dt, device)
        self.wg = (_param((d, ff), dt, device)
                   if cfg.activation == "swiglu" else None)
        self.wo = _param((ff, d), dt, device)


class MoE(nn.Module):
    """The router (d, E) in f32 and the experts' stacked SwiGLU weights."""
    RANDOM = ("router", "wi", "wg", "wo")
    REF = {"router": ("router", "w"), "wi": ("wi", "w"), "wg": ("wg", "w"),
           "wo": ("wo", "w")}
    SPLIT = {"wi": 0, "wg": 0, "wo": 0}     # expert-parallel
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        m = cfg.moe
        dt, d, ff, E = L.dtype_of(cfg), cfg.d_model, m.d_ff, m.n_experts
        self.router = _param((d, E), torch.float32, device)
        self.wi = _param((E, d, ff), dt, device)
        self.wg = _param((E, d, ff), dt, device)
        self.wo = _param((E, ff, d), dt, device)


class Mamba(nn.Module):
    """In a region a rank holds d_inner / n channels: its columns of both
    halves of ``in_proj``, of the conv, ``dt_proj`` and its bias, its rows
    of ``A_log``, ``D``, ``x_proj`` and ``out_proj``."""
    RANDOM = ("in_proj", "conv_w", "x_proj", "dt_proj_w", "out_proj")
    REF = {"in_proj": ("in_proj", "w"), "conv_w": ("conv", "w"),
           "conv_b": ("conv", "b"), "x_proj": ("x_proj", "w"),
           "dt_proj_w": ("dt_proj", "w"), "dt_proj_b": ("dt_proj", "b"),
           "A_log": ("A_log",), "D": ("D",), "out_proj": ("out_proj", "w")}
    SPLIT = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
             "dt_proj_w": 1, "dt_proj_b": 0, "A_log": 0, "D": 0,
             "out_proj": 0}                          # by channels
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        s, dt, d = cfg.ssm, L.dtype_of(cfg), cfg.d_model
        di, dr = S.d_inner(cfg), S.dt_rank(cfg)
        f32 = torch.float32
        self.in_proj = _param((d, 2 * di), dt, device)
        self.conv_w = _param((s.d_conv, di), dt, device)
        self.conv_b = _param((di,), f32, device)
        self.x_proj = _param((di, dr + 2 * s.d_state), dt, device)
        self.dt_proj_w = _param((dr, di), dt, device)
        self.dt_proj_b = _param((di,), f32, device)
        self.A_log = _param((di, s.d_state), f32, device)
        self.D = _param((di,), f32, device)
        self.out_proj = _param((di, d), dt, device)

    def reset_constants(self) -> None:
        """S4D-real A, Δt bias softplus⁻¹(0.01), D = 1, as the reference."""
        self.conv_b.zero_()
        self.dt_proj_b.fill_(-4.6)
        ds = self.A_log.shape[1]
        a = torch.arange(1, ds + 1, dtype=torch.float32,
                         device=self.A_log.device)
        self.A_log.copy_(torch.log(a)[None, :].expand_as(self.A_log))
        self.D.fill_(1.0)

    def split_ranges(self, n: int):
        """Each rank's channels over n ranks (both halves of in_proj's
        columns), or None (kept whole) where n does not divide them."""
        di = self.D.shape[0]
        ch = channel_ranges(di, n)
        if ch is None:
            return None
        out = {k: ch for k in self.SPLIT}
        out["in_proj"] = tuple(((a, b), (di + a, di + b)) for (a, b), in ch)
        return out


def channel_ranges(di: int, n: int):
    """Each of n ranks' Mamba channels of ``di``, or None (kept whole)
    where n does not divide them."""
    return None if di % n else SH.even_ranges(di, n)


class MLSTM(nn.Module):
    """Weights whole in every step (``tp_friendly=False``); ``tp``, where a
    sharded server sets it, splits the decode state
    (``xlstm.state_blocks``)."""
    RANDOM = ("up", "wq", "wk", "wv", "wi", "wf", "down")
    REF = {"up": ("up", "w"), "wq": ("wq", "w"), "wk": ("wk", "w"),
           "wv": ("wv", "w"), "wi": ("wi", "w"), "wf": ("wf", "w"),
           "norm": ("norm", "g"), "down": ("down", "w")}
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, d, H = L.dtype_of(cfg), cfg.d_model, cfg.n_heads
        di, dh = X.m_dims(cfg)
        self.up = _param((d, 2 * di), dt, device)
        self.wq = _param((H, dh, dh), dt, device)    # block-diagonal
        self.wk = _param((H, dh, dh), dt, device)
        self.wv = _param((H, dh, dh), dt, device)
        self.wi = _param((di, H), torch.float32, device)
        self.wf = _param((di, H), torch.float32, device)
        self.norm = _param((di,), torch.float32, device)
        self.down = _param((di, d), dt, device)

    def reset_constants(self) -> None:
        self.norm.fill_(1.0)


class SLSTM(nn.Module):
    """As :class:`MLSTM`: ``tp`` splits the decode state alone."""
    RANDOM = ("wx", "rz", "ri", "rf", "ro", "ff_up", "ff_down")
    REF = {"wx": ("wx", "w"), "rz": ("rz",), "ri": ("ri",), "rf": ("rf",),
           "ro": ("ro",), "norm": ("norm", "g"), "ff_up": ("ff_up", "w"),
           "ff_down": ("ff_down", "w")}
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = L.dtype_of(cfg)
        d, dh = X.s_dims(cfg)
        H = cfg.n_kv_heads
        dff = int(cfg.xlstm.proj_factor_s * d)
        self.wx = _param((d, 4 * d), dt, device)     # z, i, f, o pre-acts
        for name in ("rz", "ri", "rf", "ro"):
            setattr(self, name, _param((H, dh, dh), torch.float32, device))
        self.norm = _param((d,), torch.float32, device)
        self.ff_up = _param((d, dff), dt, device)
        self.ff_down = _param((dff, d), dt, device)

    def reset_constants(self) -> None:
        self.norm.fill_(1.0)


_MIXER_MODULES = {"attn": Attention, "attn_bidir": Attention,
                  "attn_cross": Attention, "cross": Attention,
                  "mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}


class Block(nn.Module):
    """One (mixer, ffn) layer: ``norm1`` + ``mixer``; for ``attn_cross``
    also ``mixer2`` (cross-attention) after ``norm1b``; ``norm2`` + ``ffn``
    unless the ffn is "none"."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn: str, device):
        super().__init__()
        if mixer not in _MIXER_MODULES:
            raise ValueError(mixer)
        self.norm1 = _norm(cfg, device)
        self.mixer = _MIXER_MODULES[mixer](cfg, device)
        self.mixer2 = (Attention(cfg, device) if mixer == "attn_cross"
                       else None)
        self.norm1b = _norm(cfg, device) if mixer == "attn_cross" else None
        if ffn == "none":
            self.norm2 = self.ffn = None
        else:
            self.norm2 = _norm(cfg, device)
            self.ffn = (MoE if ffn == "moe" else FFN)(cfg, device)


class Encoder(nn.Module):
    """The whisper encoder over stub-frontend frames: positions, a stack of
    (attn_bidir, dense) blocks and a final LayerNorm."""
    RANDOM = ("pos",)
    SCALES = {"pos": 0.02}

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        enc = cfg.encoder
        self.pos = _param((enc.n_frames, cfg.d_model), L.dtype_of(cfg),
                          device)
        self.blocks = nn.ModuleList(
            Block(cfg, "attn_bidir", "dense", device)
            for _ in range(enc.n_layers))
        self.final_norm = Norm(cfg.d_model, True, device)


class LM(nn.Module):
    """Parameters of an LM, allocated uninitialized on ``device`` (fill
    them with ``init`` or ``convert.lm_params_from_numpy``)."""
    RANDOM = ("embed", "head")
    SCALES = {"embed": 0.02, "head": 0.02}
    SPLIT = {"embed": 0, "head": 0}         # vocab-parallel
    tp: Optional[TP.Region] = None

    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        dev = resolve(device)
        dt = L.dtype_of(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, dev)
        self.head = (None if cfg.tie_embeddings
                     else _param((cfg.vocab, cfg.d_model), dt, dev))
        self.final_norm = _norm(cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, layer.mixer, layer.ffn, dev)
                                    for layer in layout(cfg))
        self.encoder = (Encoder(cfg, dev) if cfg.encoder is not None
                        else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_table(self) -> torch.Tensor:
        return self.embed if self.head is None else self.head


def param_stacks(cfg: ModelConfig, names) -> Dict[str, list]:
    """The parameter ``names`` (of ``named_parameters()``) that the
    reference stacks into one leaf over the periods of the block pattern:
    {stack name: member names in period order}, each stack named by its
    period-0 member. Layer ``li`` of the decoder stacks with the layers at
    its pattern position ``li % P``, and every encoder block with the
    others; the embedding, the head, the final norms and the encoder's
    positions stand alone and are in no stack."""
    P = len(cfg.pattern)
    stacks: Dict[tuple, list] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks":
            li, key = int(parts[1]), ("blocks", int(parts[1]) % P, *parts[2:])
        elif parts[:2] == ["encoder", "blocks"]:
            li, key = int(parts[2]), ("encoder", *parts[3:])
        else:
            continue
        stacks.setdefault(key, []).append((li, name))
    return {members[0][1]: [n for _, n in members]
            for members in map(sorted, stacks.values())}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator,
         device: Device = None) -> LM:
    """Random weights with the reference's scales: normal / sqrt(d_in) for
    weights (d_in the next-to-last dim: (d_in, d_out) matrices, (E, d_in,
    d_out) experts, (H, dh, dh) head blocks), normal · 0.02 for the
    embedding, the head and the encoder's positions; norms ones (and
    zeros), and the Mamba constants. Draws are made in f32 on the
    generator's device, one leading index at a time for stacked weights,
    then cast; the same generator state gives the same model."""
    model = LM(cfg, device)

    def fill(p: torch.Tensor, scale: float) -> None:
        for part in (p if p.dim() >= 3 else (p,)):
            x = torch.randn(part.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
            part.copy_((x * scale).to(part.dtype))

    for mod in model.modules():
        scales = getattr(mod, "SCALES", {})
        for name in getattr(mod, "RANDOM", ()):
            p = getattr(mod, name)
            if p is not None:
                fill(p, scales.get(name, 1.0 / math.sqrt(p.shape[-2])))
        if hasattr(mod, "reset_constants"):
            mod.reset_constants()
    return model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _ffn(blk: Block, cfg: ModelConfig, ffn: str, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x after the layer's FFN, and the MoE aux loss (None without MoE)."""
    if ffn == "dense":
        return x + L.ffn_apply(blk.ffn, L.apply_norm(cfg, blk.norm2, x),
                               cfg.activation), None
    if ffn == "moe":
        y, aux = M.moe_apply(blk.ffn, cfg, L.apply_norm(cfg, blk.norm2, x))
        return x + y, aux
    return x, None


_FULL = {"mamba": S.mamba_forward, "mlstm": X.mlstm_forward,
         "slstm": X.slstm_forward}
#: decode steps: each on the rank's blocks of its state where its module
#: carries a region
_STEP = {"mamba": S.mamba_decode, "mlstm": X.mlstm_step,
         "slstm": X.slstm_step}


def _state(cache: Cache, layer: Layer) -> Tuple[torch.Tensor, ...]:
    """Views of one layer's state in ``cache``."""
    return tuple(cache.state[k][layer.slot]
                 for k in STATE_KEYS[layer.group])


def _put_state(cache: Cache, layer: Layer, values) -> None:
    for dst, src in zip(_state(cache, layer), values):
        dst.copy_(src)


def _kept(cfg: ModelConfig, group: str, seq: Optional[TP.Region], values):
    """A prefill's final state of a layer of ``group`` as the cache keeps
    it: in a sharded step (``seq``) xLSTM's, computed whole, narrowed to
    the rank's blocks (``xlstm.state_blocks``); Mamba's is the rank's
    channels already."""
    if seq is None or group not in ("mlstm", "slstm"):
        return values
    blocks = X.state_blocks(cfg, seq.size, seq.rank)
    return tuple(TP.narrow(t, blocks[k])
                 for k, t in zip(STATE_KEYS[group], values))


def _forward(cfg: ModelConfig, blocks, layers, x: torch.Tensor,
             positions: torch.Tensor, cross_x: Optional[torch.Tensor],
             cache: Optional[Cache] = None,
             materialize: Optional[Callable] = None,
             seq: Optional[TP.Region] = None):
    """The full-sequence pass of ``blocks`` (``layers`` their layout) over
    x (B, S, d); returns (x, the list of the MoE layers' aux losses). With
    ``cache``, each layer's K/V (at positions 0..S-1), cross K/V and final
    recurrent state are written into it (in a sharded step, ``seq`` its
    region, the rank's block of each, ``make_cache(tp=)``).
    ``materialize(period's blocks)``, when given, is called before each
    period of the block pattern runs."""
    aux = []
    P = len(cfg.pattern)
    for i, (blk, layer) in enumerate(zip(blocks, layers)):
        if materialize is not None and i % P == 0:
            materialize(blocks[i:i + P])
        mixer = layer.mixer
        h = L.apply_norm(cfg, blk.norm1, x)
        if mixer in SELF_ATTN:
            if cache is not None:
                y, (k, v) = L.attention_prefill_cache(
                    blk.mixer, cfg, h, positions, seq=seq,
                    max_seq=cache.max_seq)
                cache.k[layer.attn, :, :k.shape[1]] = k
                cache.v[layer.attn, :, :v.shape[1]] = v
            else:
                y = L.attention(blk.mixer, cfg, h, positions=positions,
                                causal=mixer != "attn_bidir")
            x = x + y
            if mixer == "attn_cross":
                kv = L.cross_kv(blk.mixer2, cfg, cross_x)
                x = x + L.cross_attention_cached(
                    blk.mixer2, cfg, L.apply_norm(cfg, blk.norm1b, x), kv)
                if cache is not None:
                    _put_state(cache, layer, L.cross_block(blk.mixer2, kv,
                                                           seq))
        elif mixer == "cross":
            kv = L.cross_kv(blk.mixer, cfg, cross_x)
            x = x + L.cross_attention_cached(blk.mixer, cfg, h, kv)
            if cache is not None:
                _put_state(cache, layer, L.cross_block(blk.mixer, kv, seq))
        else:
            y, st = _FULL[mixer](blk.mixer, cfg, h)
            x = x + y
            if cache is not None:
                _put_state(cache, layer, _kept(cfg, layer.group, seq, st))
        x, a = _ffn(blk, cfg, layer.ffn, x)
        if a is not None:
            aux.append(a)
    return x, aux


def _encode(model: LM, cfg: ModelConfig, frames: torch.Tensor):
    """The whisper encoder over stub-frontend frames (B, T, d)."""
    enc = model.encoder
    T = frames.shape[1]
    x = frames + enc.pos[None, :T]
    positions = torch.arange(T, device=frames.device)[None]
    layers = (Layer("attn_bidir", "dense", -1, "", -1),) * len(enc.blocks)
    x, _ = _forward(cfg, enc.blocks, layers, x, positions, None)
    return L.layer_norm(enc.final_norm.g, enc.final_norm.b, x, cfg.norm_eps)


def _cross_input(model: LM, cfg: ModelConfig,
                 frames: Optional[torch.Tensor],
                 patches: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """What cross-attention reads: the encoder's output over ``frames``
    (audio), the ``patches`` (vlm), or None."""
    if cfg.family not in ("audio", "vlm"):
        return None
    name, t = (("frames", frames) if cfg.family == "audio"
               else ("patches", patches))
    if t is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs {name}")
    if t.dtype not in (torch.bfloat16, L.dtype_of(cfg)):
        raise ValueError(f"{name} must be bfloat16 or {L.dtype_of(cfg)}, "
                         f"got {t.dtype}")
    return _encode(model, cfg, t) if cfg.family == "audio" else t


def _final_logits(model: LM, cfg: ModelConfig, x: torch.Tensor):
    return L.unembed(model.head_table(), TP.copy_to(
        L.apply_norm(cfg, model.final_norm, x), model.tp))


def _last_logits(model: LM, cfg: ModelConfig, x: torch.Tensor):
    """(B, vocab) f32 logits of x (B, 1, d), whole over the vocabulary
    (gathered in a region)."""
    return TP.gather_vocab(_final_logits(model, cfg, x)[:, 0], model.tp)


def _step_region(model: LM) -> Optional[TP.Region]:
    """The region a sharded step set on ``model``'s modules (all of them
    share one), or None."""
    return next((m.tp for m in model.modules()
                 if getattr(m, "tp", None) is not None), None)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

#: the reference's remat policies: "full" keeps only period boundaries;
#: "save_ffn_hidden" also keeps each dense FFN's hidden product
REMAT_POLICIES = ("full", "save_ffn_hidden")


def _save_ffn_hidden(blocks):
    """Selective-checkpoint contexts that keep, through the recompute of
    ``blocks``, the outputs of the products that make each dense FFN's
    hidden activation: ``x @ wi`` and ``x @ wg``, the ``aten.mm`` ops
    whose right operand is one of those weights (the reference saves the
    hidden product by name, ``checkpoint_name(h, "ffn_hidden")``). Eager
    recompute has no dead-code elimination: a saved product alone would
    still run the matmuls that feed it, so the products themselves are
    kept, and the recompute runs neither; the silu and the gate product
    are recomputed from them, to the same bits. The weights are found by
    their storage when the op runs (a sharded trainer fills them anew for
    the recompute)."""
    weights = [w for blk in blocks if isinstance(blk.ffn, FFN)
               for w in (blk.ffn.wi, blk.ffn.wg) if w is not None]

    def policy(ctx, op, *args, **kwargs):
        if (op is torch.ops.aten.mm.default
                and args[1].data_ptr() in {w.data_ptr() for w in weights}):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _periods(cfg: ModelConfig, model: LM):
    """(blocks, layers) of each period of the block pattern."""
    P, lay = len(cfg.pattern), layout(cfg)
    return [(model.blocks[p:p + P], lay[p:p + P])
            for p in range(0, cfg.n_layers, P)]


def train_logits(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                 frames: Optional[torch.Tensor] = None,
                 patches: Optional[torch.Tensor] = None,
                 remat: bool = False, remat_policy: str = "full",
                 materialize: Optional[Callable] = None):
    """(B, S) tokens -> ((B, S, vocab) f32 logits, causal; the MoE aux
    loss summed over the layers, a 0-d f32, 0 without MoE). In a region
    (``model.tp``) the logits are this rank's slice of the vocabulary.

    ``remat`` checkpoints each period of the pattern (non-reentrant
    ``torch.utils.checkpoint``): only period boundaries are kept for the
    backward, which runs each period's forward again (``remat_policy``
    "full", the reference's default); "save_ffn_hidden" also keeps the
    dense FFNs' hidden products (``_save_ffn_hidden``), the same loss and
    gradients with two matmuls a layer fewer in the backward. Without grad
    it changes nothing.

    ``materialize(blocks)``, when given, is called before each period
    runs, and again before its recompute (inside the checkpointed region;
    the sharded trainer fills the period's parameters there)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}: one of "
                         f"{REMAT_POLICIES}")
    x = L.embed(model.embed, tokens, model.tp)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    cross_x = _cross_input(model, cfg, frames, patches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blocks, layers in _periods(cfg, model):
        if remat and torch.is_grad_enabled():
            kw = ({} if remat_policy == "full" else
                  {"context_fn": _save_ffn_hidden(blocks)})
            x, a = checkpoint(_forward, cfg, blocks, layers, x, positions,
                              cross_x, None, materialize,
                              use_reentrant=False, **kw)
        else:
            x, a = _forward(cfg, blocks, layers, x, positions, cross_x,
                            None, materialize)
        for term in a:
            aux = aux + term
    return _final_logits(model, cfg, x), aux


def loss_fn(model: LM, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            remat: bool = True, aux_weight: float = 0.01,
            remat_policy: str = "full",
            materialize: Optional[Callable] = None):
    """The reference's training loss: (mean next-token NLL over labels >=
    0 + aux_weight * MoE aux, {"nll": that mean, "aux": the aux loss}).

    ``batch`` holds ``tokens`` and ``labels`` (B, S) and, for the audio and
    vision families, ``frames`` / ``patches`` as ``train_logits`` takes
    them. The log-sum-exp subtracts the row max with its gradient detached
    (the reference's ``stop_gradient``); the label logit is a gather, the
    same sum as the reference's one-hot product (``tensor_parallel.nll``,
    vocab-parallel in a region)."""
    logits, aux = train_logits(model, cfg, batch["tokens"],
                               batch.get("frames"), batch.get("patches"),
                               remat=remat, remat_policy=remat_policy,
                               materialize=materialize)
    labels = batch["labels"].to(torch.int64)
    nll = TP.nll(logits, labels.clamp(min=0), model.tp)
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


def cache_widths(cfg: ModelConfig, tp: Optional[TP.Region] = None,
                 cross_tokens: Optional[int] = None
                 ) -> Dict[str, TP.Block]:
    """{``Cache.state`` key: the rank's block of one layer's leaf (B,
    ...)} in the region ``tp``, as the reference's ``cache_specs`` lays the
    stacked leaves out over 'model': the Mamba state's channels (where its
    module splits them, ``channel_ranges``); the cross K/V's positions of
    their ``cross_tokens`` (default ``cfg.cross_kv_tokens``) T at every KV
    head (``tensor_parallel.seq_range``); the xLSTM states on the axis the
    rule picks (``xlstm.state_blocks``: mLSTM's C over heads or its value
    axis, n over its last axis, m over heads or whole, the sLSTM's over
    dh). A leaf absent is whole; all of them outside a region. Read from
    the config, since a sharded step may size a cache while its weights
    are empty. (The self-attention K/V hold every KV head at the rank's
    positions, ``make_cache``.)"""
    if tp is None:
        return {}
    groups = group_sizes(cfg)
    out: Dict[str, TP.Block] = {}
    ch = cfg.ssm and channel_ranges(S.d_inner(cfg), tp.size)
    if ch and "mamba" in groups:
        (a, b), = ch[tp.rank]
        out.update({"mamba.h": TP.Block(1, a, b),
                    "mamba.conv": TP.Block(2, a, b)})
    if "cross" in groups:
        lo, hi = TP.seq_range(cross_tokens or cfg.cross_kv_tokens, tp)
        out.update({k: TP.Block(1, lo, hi) for k in STATE_KEYS["cross"]})
    if "mlstm" in groups or "slstm" in groups:
        out.update((k, b) for k, b in X.state_blocks(
            cfg, tp.size, tp.rank).items() if b is not None)
    return out


def make_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device: Device = None,
               kv_len: Optional[torch.Tensor] = None,
               cross_tokens: Optional[int] = None,
               tp: Optional[TP.Region] = None) -> Cache:
    """An empty decode cache (zeros; the stabilizers at the reference's
    -1e30), with ``kv_len`` marking the fill; cross K/V hold
    ``cross_tokens`` (default ``cfg.cross_kv_tokens``) positions. In the
    region ``tp`` every leaf is the rank's block of it as the reference's
    ``cache_specs`` lays it out: the self-attention K/V every KV head at
    the rank's positions of ``max_seq`` (``tensor_parallel.seq_range``:
    the sequence over 'model'), the state leaves as ``cache_widths``
    gives them."""
    dev = resolve(device)
    dt = L.dtype_of(cfg)
    B = batch_size
    T = cross_tokens or cfg.cross_kv_tokens
    blocks = cache_widths(cfg, tp, T)
    lo, hi = TP.seq_range(max_seq, tp)
    shp = (n_attn(cfg), B, hi - lo, cfg.n_kv_heads, cfg.hd)
    sizes = group_sizes(cfg)
    # one row of each group's whole state, narrowed to the rank's block
    init = {"mamba": lambda: S.init_state(cfg, 1, dt, dev),
            "mlstm": lambda: X.init_mlstm_state(cfg, 1, dev),
            "slstm": lambda: X.init_slstm_state(cfg, 1, dev),
            "cross": lambda: (torch.zeros((1, T, cfg.n_kv_heads, cfg.hd),
                                          dtype=dt, device=dev),) * 2}
    state: Dict[str, torch.Tensor] = {}
    for group, n in sizes.items():
        for key, t in zip(STATE_KEYS[group], init[group]()):
            t = TP.narrow(t, blocks.get(key))
            state[key] = t[None].repeat((n, B) + (1,) * (t.dim() - 1))
    if kv_len is None:
        kv_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    return Cache(k=torch.zeros(shp, dtype=dt, device=dev),
                 v=torch.zeros(shp, dtype=dt, device=dev),
                 kv_len=kv_len.to(device=dev, dtype=torch.int32),
                 state=state, max_seq=None if tp is None else max_seq)


def group_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """Layers per state group (``STATE_KEYS``) of the decoder."""
    out: Dict[str, int] = {}
    for layer in layout(cfg):
        if layer.group:
            out[layer.group] = out.get(layer.group, 0) + 1
    return out


def bucketable(cfg: ModelConfig) -> bool:
    """Whether padding a prompt past its length is exact: for
    pure-attention patterns without MoE only (a recurrent mixer integrates
    padding into its state, and MoE capacity lets padding tokens displace
    real ones from expert slots)."""
    return all(m == "attn" and f != "moe" for m, f in cfg.pattern)


def prefill(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: Optional[int] = None,
            length: Optional[int] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            materialize: Optional[Callable] = None):
    """Run the prompt (B, S); return (last-token logits (B, vocab) f32,
    Cache allocated at ``max_seq`` (default S) holding the prompt's K/V,
    cross K/V and recurrent state). In the regions of a sharded step the
    cache holds the rank's block (``make_cache(tp=)``) and the logits are
    gathered whole; ``materialize(blocks)``, when given, is called before
    each period of the block pattern runs.

    ``length`` is **bucketed prefill**: the tokens may be padded past the
    real prompt, logits are read at row ``length - 1`` and ``kv_len`` marks
    only the real prompt, so the padded tail cannot reach any output —
    exact for :func:`bucketable` patterns only, which alone may pad."""
    B, Sq = tokens.shape
    max_seq = max_seq or Sq
    if Sq > max_seq:
        raise ValueError(f"prompt of {Sq} tokens exceeds max_seq {max_seq}")
    fill = Sq if length is None else int(length)
    if fill != Sq and not bucketable(cfg):
        raise ValueError(f"{cfg.name}: pattern {cfg.pattern} cannot pad a "
                         f"prompt ({fill} tokens padded to {Sq})")
    cross_x = _cross_input(model, cfg, frames, patches)
    seq = _step_region(model)
    cache = make_cache(cfg, B, max_seq, tokens.device,
                       kv_len=torch.full((B,), fill, dtype=torch.int32),
                       cross_tokens=(None if cross_x is None
                                     else cross_x.shape[1]),
                       tp=seq)
    x = L.embed(model.embed, tokens, model.tp)
    positions = torch.arange(Sq, device=tokens.device)[None]
    x, _ = _forward(cfg, model.blocks, layout(cfg), x, positions, cross_x,
                    cache, materialize, seq)
    return _last_logits(model, cfg, x[:, fill - 1:fill]), cache


def prefill_extend(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                   prefix: Tuple[torch.Tensor, torch.Tensor],
                   max_seq: Optional[int] = None,
                   prefix_len: Optional[int] = None,
                   length: Optional[int] = None):
    """Prefill only the uncached suffix of a prompt (paged prefix reuse).

    ``tokens`` is the (B, S_new) suffix; ``prefix`` is (k, v), each
    (n_layers, B, S_pre, Hkv, D): the cached whole-block prefix gathered by
    ``serving.kvcache.PagedKVStore``. Returns (last-token logits (B, vocab)
    f32, Cache at ``max_seq`` covering prefix + suffix), as ``prefill`` on
    the concatenated prompt would up to rounding (for MoE, capacity counts
    the suffix's tokens, as in the reference).

    **Bucketed mode** (``prefix_len`` given): the prefix buffer is padded
    past its ``prefix_len`` real rows and the suffix may be padded past its
    true length ``length``. The suffix's K/V is written at offset
    ``prefix_len`` of the max_seq cache (clamped to ``max_seq - S_new`` as
    JAX's ``dynamic_update_slice`` clamps), logits are read at row
    ``length - 1``, and ``kv_len`` is ``prefix_len + length``.

    Pure-attention patterns only (every mixer "attn"): recurrent mixers
    carry no position-sliceable prefix state."""
    if not all(m == "attn" for m, _ in cfg.pattern):
        raise ValueError(f"{cfg.name}: prefill_extend supports "
                         f"pure-attention block patterns")
    B, Sn = tokens.shape
    k_pre, v_pre = prefix
    S_pre = k_pre.shape[2]
    bucketed = prefix_len is not None
    if bucketed:
        start = int(prefix_len)
        last = Sn if length is None else int(length)
        if max_seq is None or max(Sn, S_pre) > max_seq:
            raise ValueError(f"bucketed extend needs max_seq >= the padded "
                             f"suffix ({Sn}) and prefix ({S_pre}), got "
                             f"{max_seq}")
    else:
        start, last = S_pre, Sn
        max_seq = max_seq or (S_pre + Sn)
        if S_pre + Sn > max_seq:
            raise ValueError(f"prompt of {S_pre} + {Sn} tokens exceeds "
                             f"max_seq {max_seq}")
    cache = make_cache(cfg, B, max_seq, tokens.device, kv_len=torch.full(
        (B,), start + last, dtype=torch.int32))
    # the prefix once for all layers; the suffix lands at `at`
    cache.k[:, :, :S_pre] = k_pre
    cache.v[:, :, :S_pre] = v_pre
    at = min(start, max_seq - Sn)
    x = L.embed(model.embed, tokens)
    positions = (start + torch.arange(Sn, device=tokens.device))[None]
    for li, (blk, layer) in enumerate(zip(model.blocks, layout(cfg))):
        y, (k, v) = L.attention_prefill_extend(
            blk.mixer, cfg, L.apply_norm(cfg, blk.norm1, x), positions,
            (k_pre[li], v_pre[li]), prefix_len=start if bucketed else None)
        cache.k[li, :, at:at + Sn] = k[:, -Sn:]
        cache.v[li, :, at:at + Sn] = v[:, -Sn:]
        x, _ = _ffn(blk, cfg, layer.ffn, x + y)
    return _last_logits(model, cfg, x[:, last - 1:last]), cache


def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, materialize: Optional[Callable] = None):
    """token: (B, 1) -> (logits (B, vocab) f32, Cache). Every row decodes,
    live or not, and every row's kv_len grows by one, as in the reference;
    K/V and recurrent state are updated in place and returned in the new
    Cache. In the regions of a sharded step ``cache`` holds the rank's
    block (``make_cache(tp=)``), attention and cross-attention run split
    over its positions (``layers.attention_decode``,
    ``layers.cross_attention_cached``), xLSTM on its state's blocks
    (``xlstm.mlstm_step``, ``slstm_step``) and the logits are gathered
    whole;
    ``materialize(blocks)``, when given, is called before each period of
    the block pattern runs."""
    seq = _step_region(model)
    if (seq is None) != (cache.max_seq is None):
        raise ValueError("a sharded step decodes a cache of the rank's "
                         "positions (make_cache(tp=)), and only it")
    x = L.embed(model.embed, token, model.tp)
    P = len(cfg.pattern)
    for li, (blk, layer) in enumerate(zip(model.blocks, layout(cfg))):
        if materialize is not None and li % P == 0:
            materialize(model.blocks[li:li + P])
        mixer = layer.mixer
        h = L.apply_norm(cfg, blk.norm1, x)
        if mixer in SELF_ATTN:
            x = x + L.attention_decode(blk.mixer, cfg, h,
                                       (cache.k[layer.attn],
                                        cache.v[layer.attn]), cache.kv_len,
                                       seq, cache.max_seq)
            if mixer == "attn_cross":
                x = x + L.cross_attention_cached(
                    blk.mixer2, cfg, L.apply_norm(cfg, blk.norm1b, x),
                    _state(cache, layer), seq)
        elif mixer == "cross":
            x = x + L.cross_attention_cached(blk.mixer, cfg, h,
                                             _state(cache, layer), seq)
        else:
            y, st = _STEP[mixer](blk.mixer, cfg, h, _state(cache, layer))
            _put_state(cache, layer, st)
            x = x + y
        x, _ = _ffn(blk, cfg, layer.ffn, x)
    return _last_logits(model, cfg, x), cache._replace(
        kv_len=cache.kv_len + 1)
