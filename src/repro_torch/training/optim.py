"""Optimizers: the counterpart of ``repro.training.optim``.

The same three memory tiers, selected by model size:

* ``adamw``     — f32 m and v (8 bytes a parameter of state);
* ``adamw8bit`` — m and v quantized to int8 in blocks of :data:`QBLOCK`
  along the last axis, with f32 scales a block (2 bytes a parameter);
* ``adafactor`` — a factored second moment (row and column means of a
  matrix) and no first moment.

Parameters, gradients and state are dicts keyed by parameter name (the
model's ``named_parameters()``), where the reference takes pytrees.
``update(grads, state, params)`` returns ``(params, state)`` as the
reference's does, but updates in place under ``torch.no_grad()``: the
parameters keep their own dtype and the moments are overwritten, so a step
holds no second copy of either. Each leaf's arithmetic is the reference's
expression for expression, in f32; the global-norm clip is applied leaf by
leaf as the leaf is updated (the same values as the reference's clipped
copy, without holding an f32 copy of every gradient at once).

The reference stacks each layer's leaves over the periods of the block
pattern; here every layer's parameter is its own tensor. ``adamw`` and
``adamw8bit`` (whose blocks run along the last axis) give the same result
either way. ``adafactor`` does not (its second moment is factored over a
leaf's last two axes, and its update clip is one RMS over the leaf), so it
takes the stacks (``lm.param_stacks``) and updates each as the reference's
one leaf.

**On blocks.** ``init`` and ``update`` take ``layouts``: {parameter name:
``sharding.BlockLayout``}, when each tensor is one rank's block of a leaf
split over process groups (the sharded trainer's). The arithmetic is then
that of the whole leaf, no rank holding it: a reduction over a split axis
is a local sum, all-reduced over the groups that split the axis and
divided by the whole count (adafactor's row and column means, the mean of
its row factor, its update RMS over the whole stacked leaf); adamw8bit's
quantization blocks are those of the whole last axis, so a block that
straddles ranks takes its scale as the max all-reduced over them, and
every rank holds a row's scales whole (their spec drops the last axis).
Without ``layouts`` each tensor is its whole leaf: the same code with no
group.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.sharding import BlockLayout
from ..models.tensor_parallel import all_reduce

QBLOCK = 256  # int8 quantization block

Tensors = Dict[str, torch.Tensor]
#: parameter names -> {stack name: member names} (``lm.param_stacks``)
Stacks = Callable[[List[str]], Dict[str, List[str]]]


#: parameter names -> the ``BlockLayout`` of each one's block
Layouts = Optional[Dict[str, BlockLayout]]


class Optimizer(NamedTuple):
    init: Callable     # (params, layouts=None) -> state
    # (grads, state, params, gnorm=None, layouts=None) -> (params, state),
    # in place; ``gnorm`` the global gradient norm when ``grads`` is a part
    update: Callable
    name: str


def _axes(layouts: Layouts, name: str, shape) -> BlockLayout:
    """``layouts[name]``, or the whole leaf of ``shape``."""
    if layouts is None:
        return BlockLayout.whole_of(shape)
    return layouts[name]


def _stacked(ax: BlockLayout, n: int) -> BlockLayout:
    """The layout of a stack of ``n`` blocks laid out as ``ax`` (the stack
    axis is never split)."""
    return BlockLayout(((),) + ax.groups, (n,) + ax.whole, (0,) + ax.offset)


def _mean(x: torch.Tensor, dim: int, groups, whole: int,
          keepdim: bool = False) -> torch.Tensor:
    """The mean over axis ``dim`` of the whole tensor whose block is
    ``x``: the local sum, summed over ``groups``, over ``whole``."""
    return all_reduce(torch.sum(x, dim=dim, keepdim=keepdim),
                       groups) / whole


def _mean_all(x: torch.Tensor, ax: BlockLayout) -> torch.Tensor:
    """The mean of every entry of the whole leaf whose block is ``x``."""
    numel = 1
    for n in ax.whole:
        numel *= n
    groups = [g for gs in ax.groups for g in gs]
    return all_reduce(torch.sum(x), groups) / numel


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _tree_norm(grads: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))


def _clip_scale(grads: Tensors, clip: float,
                gnorm: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm): gradients times ``scale`` have norm <= clip.
    ``gnorm``, when given, is the global norm (of more gradients than
    ``grads``: a sharded trainer updates its blocks)."""
    if gnorm is None:
        gnorm = _tree_norm(grads)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    return scale, gnorm


def _clipped(grads: Tensors, clip: float) -> Tuple[Tensors, torch.Tensor]:
    """The reference's ``_clipped``: f32 gradients scaled to global norm <=
    ``clip``, and the norm before clipping."""
    scale, gnorm = _clip_scale(grads, clip)
    return {k: g.to(torch.float32) * scale for k, g in grads.items()}, gnorm


def _bias_corrections(cfg: OptConfig, step: torch.Tensor):
    s = step.to(torch.float32)
    return 1 - cfg.b1 ** s, 1 - cfg.b2 ** s


def _scalars(params: Tensors) -> Tensors:
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "gnorm": torch.zeros((), dtype=torch.float32, device=dev)}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(cfg: OptConfig = OptConfig()) -> Optimizer:
    def init(params: Tensors, layouts: Layouts = None):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()},
                **_scalars(params)}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, gnorm=None,
               layouts: Layouts = None):
        scale, gnorm = _clip_scale(grads, cfg.grad_clip, gnorm)
        step = state["step"] + 1
        b1c, b2c = _bias_corrections(cfg, step)
        for k, p in params.items():
            g = grads[k].to(torch.float32) * scale
            m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
            v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g * g
            mh = m / b1c
            vh = v / b2c
            pf = p.to(torch.float32)
            new_p = pf - cfg.lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                   + cfg.weight_decay * pf)
            p.copy_(new_p)
            state["m"][k].copy_(m)
            state["v"][k].copy_(v)
        return params, {"m": state["m"], "v": state["v"], "step": step,
                        "gnorm": gnorm}

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# 8-bit AdamW (block-wise dynamic quantization)
# ---------------------------------------------------------------------------

def _blocks(ax: BlockLayout, w: int) -> Tuple[int, int, int, int, int]:
    """The quantization blocks that a block of ``w`` columns at
    ``ax.offset[-1]`` of the whole last axis touches: (block size, columns
    of its first block before it, index of that block, blocks touched,
    blocks of the whole axis)."""
    last = ax.whole[-1]
    block = min(QBLOCK, last)
    lead = ax.offset[-1] % block
    return (block, lead, ax.offset[-1] // block, -(-(lead + w) // block),
            -(-last // block))


def _q8(x: torch.Tensor, ax: Optional[BlockLayout] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize f32 in blocks along the LAST axis -> (int8 of x's shape,
    f32 scales (..., n_blocks)); round half to even, as ``jnp.round``.
    With ``ax`` (``x`` a block of the leaf) the blocks are the whole
    axis's, each scale the max over every rank holding part of its block,
    and the scales are those of the whole axis."""
    ax = ax or BlockLayout.whole_of(x.shape)
    w = x.shape[-1]
    block, lead, first, n, nb = _blocks(ax, w)
    xp = F.pad(x, (lead, n * block - lead - w))
    xb = xp.reshape(x.shape[:-1] + (n, block))
    amax = torch.amax(torch.abs(xb), dim=-1)
    if ax.groups[-1]:       # the axis is split: scales from every part
        whole = amax.new_zeros(x.shape[:-1] + (nb,))
        whole[..., first:first + n] = amax
        amax = all_reduce(whole, ax.groups[-1], dist.ReduceOp.MAX)
    s = amax / 127.0
    s = torch.where(s == 0, 1.0, s)
    q = (xb / s[..., first:first + n, None]).round_().clamp_(-127, 127)
    q = q.to(torch.int8).reshape(xp.shape)[..., lead:lead + w]
    return q, s


def _dq8(q: torch.Tensor, s: torch.Tensor, shape,
         ax: Optional[BlockLayout] = None) -> torch.Tensor:
    ax = ax or BlockLayout.whole_of(shape)
    w = shape[-1]
    block, lead, first, n, _ = _blocks(ax, w)
    qp = F.pad(q, (lead, n * block - lead - w))
    xb = qp.reshape(tuple(shape[:-1]) + (n, block)).to(torch.float32)
    xf = xb.mul_(s[..., first:first + n, None])
    return xf.reshape(qp.shape)[..., lead:lead + w]


def adamw8bit(cfg: OptConfig = OptConfig()) -> Optimizer:
    def init(params: Tensors, layouts: Layouts = None):
        """Zero codes and unit scales (what quantizing zeros gives), the
        scales over the whole last axis."""
        def zq(k, p):
            nb = _blocks(_axes(layouts, k, p.shape), p.shape[-1])[-1]
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.ones(p.shape[:-1] + (nb,),
                                    dtype=torch.float32, device=p.device)}
        return {"m": {k: zq(k, p) for k, p in params.items()},
                "v": {k: zq(k, p) for k, p in params.items()},
                **_scalars(params)}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, gnorm=None,
               layouts: Layouts = None):
        scale, gnorm = _clip_scale(grads, cfg.grad_clip, gnorm)
        step = state["step"] + 1
        b1c, b2c = _bias_corrections(cfg, step)
        for k, p in params.items():
            ax = _axes(layouts, k, p.shape)
            # the reference's expressions, evaluated in place where a
            # temporary is fresh (the same roundings; an expert leaf's f32
            # temporaries are GBs)
            g = grads[k].to(torch.float32) * scale
            mq, vq = state["m"][k], state["v"][k]
            m = _dq8(mq["q"], mq["s"], p.shape, ax).mul_(cfg.b1).add_(
                (1 - cfg.b1) * g)
            v = _dq8(vq["q"], vq["s"], p.shape, ax).mul_(cfg.b2).add_(
                ((1 - cfg.b2) * g).mul_(g)).clamp_(min=0.0)
            del g
            pf = p.to(torch.float32)
            u = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
            u = u.add_(cfg.weight_decay * pf).mul_(cfg.lr)
            p.copy_(pf - u)
            del pf, u
            for mom, x in ((mq, m), (vq, v)):
                q, sc = _q8(x, ax)
                mom["q"].copy_(q)
                mom["s"].copy_(sc)
        return params, {"m": state["m"], "v": state["v"], "step": step,
                        "gnorm": gnorm}

    return Optimizer(init, update, "adamw8bit")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------

def adafactor(cfg: OptConfig = OptConfig(),
              stacks: Optional[Stacks] = None) -> Optimizer:
    """``stacks`` (``lm.param_stacks`` bound to a config) names the
    parameters that the reference stacks into one leaf over the periods of
    the block pattern. Each stack is then updated as that one leaf: its
    members' gradients and parameters stacked, the second moment factored
    over the stacked shape (so a layer's 1-D gain is a row of a matrix)
    and the relative-update clip taken over the whole stack; its state
    ``f[stack name]`` has the reference's stacked shapes. Without
    ``stacks`` every parameter is a leaf of its own. A stack's members
    share one layout (``layouts`` of its first), and its blocks stack
    into the block of the stacked leaf."""
    def leaves(params: Tensors):
        """(state key, member names, stacked) of every leaf."""
        groups = stacks(list(params)) if stacks is not None else {}
        grouped = {n for members in groups.values() for n in members}
        return ([(k, [k], False) for k in params if k not in grouped]
                + [(k, members, True) for k, members in groups.items()])

    def init(params: Tensors, layouts: Layouts = None):
        def fac(shape, device):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa
                                          device=device)
            if len(shape) >= 2:
                return {"vr": z(shape[:-1]),
                        "vc": z(shape[:-2] + shape[-1:])}
            return {"v": z(shape)}
        f = {}
        for key, members, stacked in leaves(params):
            p = params[members[0]]
            f[key] = fac(((len(members),) if stacked else ()) + p.shape,
                         p.device)
        return {"f": f, **_scalars(params)}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, gnorm=None,
               layouts: Layouts = None):
        scale, gnorm = _clip_scale(grads, cfg.grad_clip, gnorm)
        step = state["step"] + 1
        decay = 1.0 - step.to(torch.float32) ** -0.8
        for key, members, stacked in leaves(params):
            ax = _axes(layouts, members[0], params[members[0]].shape)
            if stacked:
                ax = _stacked(ax, len(members))
                g = torch.stack([grads[n].to(torch.float32)
                                 for n in members]) * scale
                pf = torch.stack([params[n].to(torch.float32)
                                  for n in members])
            else:
                g = grads[key].to(torch.float32) * scale
                pf = params[key].to(torch.float32)
            f = state["f"][key]
            g2 = g * g + 1e-30
            if g.dim() >= 2:
                rows, cols = ((ax.groups[i], ax.whole[i]) for i in (-2, -1))
                vr = decay * f["vr"] + (1 - decay) * _mean(g2, -1, *cols)
                vc = decay * f["vc"] + (1 - decay) * _mean(g2, -2, *rows)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(_mean(vr, -1, *rows, keepdim=True)
                                       [..., None], min=1e-30))
                upd_ = g * torch.rsqrt(denom + 1e-30)
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = decay * f["v"] + (1 - decay) * g2
                upd_ = g * torch.rsqrt(v + 1e-30)
                f["v"].copy_(v)
            # relative update clipping (Adafactor's d = 1.0)
            rms = torch.sqrt(_mean_all(upd_ * upd_, ax) + 1e-30)
            upd_ = upd_ / torch.clamp(rms, min=1.0)
            new_p = (pf - cfg.lr * upd_
                     - cfg.lr * cfg.weight_decay * pf)
            if stacked:
                for n, row in zip(members, new_p):
                    params[n].copy_(row)
            else:
                params[key].copy_(new_p)
        return params, {"f": state["f"], "step": step, "gnorm": gnorm}

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, cfg: OptConfig = OptConfig(),
                   stacks: Optional[Stacks] = None) -> Optimizer:
    """The optimizer ``name``; ``stacks`` as ``adafactor`` takes it (the
    other two update element by element, or in blocks along the last axis,
    and give the same result whether a layer is a leaf or a row of one)."""
    if name == "adafactor":
        return adafactor(cfg, stacks)
    return {"adamw": adamw, "adamw8bit": adamw8bit}[name](cfg)


def optimizer_for_arch(total_params: float) -> str:
    """Memory-tier policy (see module docstring)."""
    if total_params > 200e9:
        return "adafactor"
    if total_params > 60e9:
        return "adamw8bit"
    return "adamw"
