"""'model'-parallel regions: the work that the reference's GSPMD splits over
the mesh's 'model' axis (``repro.models.sharding``'s rules), written out as
Megatron-style operators on a process group.

A :class:`Region` is the 'model' axis's process group as one rank sees it.
The sharded trainer (``training.trainer``) sets it as the ``tp`` attribute
of each module whose weights it filled as this rank's 'model' blocks
(``sharding.model_split``), for the length of a step; everywhere else
``tp`` is None and each operator below is the plain computation. Tokens
and activations between regions are whole and the same on every rank of
the group (the rows of one data-parallel rank):

* a column- then row-parallel FFN: :func:`copy_to` (identity forward,
  gradient summed over the group) at its input, the local products, and
  :func:`reduce_from` (sum over the group forward, identity backward) at
  its output;
* experts: each rank runs its own experts' slice of the dispatch buffer
  behind :func:`copy_to`, then :func:`gather` (all-gather forward; each
  rank's slice of the gradient backward: the combine that reads the
  gathered buffer runs alike on every rank, so each already holds the
  whole gradient of it);
* the vocabulary: ``layers.embed`` (rows outside the rank's slice masked
  to zero, then :func:`reduce_from`), :func:`copy_to` at the head's input,
  and :func:`nll` over the rank's logits (max and sum of exponentials
  all-reduced, the label's logit from the rank that holds it).

On a region of one rank every collective is the identity, so the result
is the plain computation's bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist


class Region(NamedTuple):
    """The 'model' axis's process group, its size and this rank's index
    in it (its coordinate: the index of its blocks)."""
    group: Any
    size: int
    rank: int


def all_reduce(x: torch.Tensor, groups, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced in place over each process group of ``groups`` in
    turn (a region passes its one group)."""
    for group in groups:
        dist.all_reduce(x, op=op, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), (ctx.region.group,)), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, region):
        return all_reduce(x.clone(), (region.group,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, region):
        ctx.region, ctx.n = region, x.shape[0]
        out = x.new_empty((region.size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x.contiguous(), group=region.group)
        return out

    @staticmethod
    def backward(ctx, g):
        lo = ctx.region.rank * ctx.n
        return g[lo:lo + ctx.n], None


def all_to_all(x: torch.Tensor, region: Region, split: int, cat: int
               ) -> torch.Tensor:
    """``x`` cut into ``region.size`` chunks along ``split``, chunk j sent
    to rank j; the chunks received, one from each rank in rank order,
    concatenated along ``cat`` (no gradient: it moves a weight between
    the blocks of storage and those of compute)."""
    inp = torch.stack(x.chunk(region.size, split))
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=region.group)
    return torch.cat(out.unbind(0), dim=cat)


def copy_to(x: torch.Tensor, region: Optional[Region]) -> torch.Tensor:
    """The input of a region: ``x`` forward; the gradient summed over the
    group backward (each rank's products see part of the work)."""
    return x if region is None else _CopyTo.apply(x, region)


def reduce_from(x: torch.Tensor, region: Optional[Region]) -> torch.Tensor:
    """The output of a region: ``x`` summed over the group forward (each
    rank's partial sum); the gradient as it is backward."""
    return x if region is None else _ReduceFrom.apply(x, region)


def gather(x: torch.Tensor, region: Optional[Region]) -> torch.Tensor:
    """Each rank's ``x`` (n, ...) concatenated along dim 0 in rank order;
    backward, this rank's slice of the gradient."""
    return x if region is None else _Gather.apply(x, region)


class _NLL(torch.autograd.Function):
    """-log softmax(logits)[label] over the vocabulary, whose rows
    [start, start + V_local) are ``logits``' last axis on this rank."""

    @staticmethod
    def forward(ctx, logits, labels, start, region):
        m = logits.amax(dim=-1, keepdim=True)
        if region is not None:
            all_reduce(m, (region.group,), dist.ReduceOp.MAX)
        e = torch.exp(logits - m)
        s = torch.sum(e, dim=-1)
        idx = labels - start
        own = (idx >= 0) & (idx < logits.shape[-1])
        idx = torch.where(own, idx, 0)
        picked = torch.where(
            own, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
        if region is not None:
            all_reduce(s, (region.group,))
            all_reduce(picked, (region.group,))
        ctx.save_for_backward(e, s, idx, own)
        return m[..., 0] + torch.log(s) - picked

    @staticmethod
    def backward(ctx, g):
        e, s, idx, own = ctx.saved_tensors
        grad = e * (g / s)[..., None]              # softmax x g
        grad.scatter_add_(-1, idx[..., None], -(g * own)[..., None])
        return grad, None, None, None


def nll(logits: torch.Tensor, labels: torch.Tensor,
        region: Optional[Region]) -> torch.Tensor:
    """(B, S) next-token NLL of f32 ``logits`` (B, S, V, or this rank's
    V / size columns of the vocabulary in a region) at ``labels`` (>= 0):
    the log-sum-exp with the row max held constant (the reference's
    ``stop_gradient``), less the label's logit; the gradient
    softmax - onehot, local to each rank."""
    start = 0 if region is None else region.rank * logits.shape[-1]
    return _NLL.apply(logits, labels, start, region)
