"""'model'-parallel regions: the work that the reference's GSPMD splits over
the mesh's 'model' axis (``repro.models.sharding``'s rules), written out as
Megatron-style operators on a process group.

A :class:`Region` is the 'model' axis's process group as one rank sees it.
The sharded trainer (``training.trainer``) and the sharded server
(``launch.serve_mesh``) set it as the ``tp`` attribute of each module whose
weights they filled as this rank's 'model' blocks
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
  all-reduced, the label's logit from the rank that holds it); a serving
  step gathers the ranks' logit slices whole (:func:`gather_vocab`);
* attention: :func:`copy_to` at the input (and at the cross-attention's
  encoder or patch input), the rank's query heads and the KV heads they
  read, the flash kernels on those local heads (training, prefill), its
  rows of ``wo`` and :func:`reduce_from`;
* the self-attention K/V cache of a serving step, as the reference's
  ``cache_specs`` lays it out: every KV head at the rank's positions
  (:func:`seq_range`). Prefill moves each KV head's positions from its
  first holder to the rank whose block holds them (:func:`seq_block`, one
  all-to-all); a decode step gathers the new token's q, k and v whole
  (:func:`gather_heads`, one all-gather: the reference's new-token
  all-gather), the rank whose block holds the position writes it, every
  rank runs the decode kernel's partial mode over its block for all query
  heads, and :func:`merge_partials` merges the ranks' (o, lse) (one
  all-gather);
* the cross-attention K/V of a serving step, every KV head at the rank's
  positions of the encoder / patch tokens T (:func:`seq_range` of T):
  prefill moves them as it moves the self K/V (:func:`seq_block`); a
  decode step gathers the query whole (:func:`gather_query`), every rank
  attends its block for all query heads, and :func:`merge_partials`
  merges;
* xLSTM's recurrent states of a serving step, each on the axis the
  reference's ``cache_specs`` splits (a :class:`Block` of it): the blocks
  that a step needs whole are all-gathered (:func:`gather_dim`), the mLSTM
  matrix C never;
* Mamba: :func:`copy_to`, the rank's channels through in_proj, the conv,
  the Δt path and the scan, ``x_proj``'s partial sums through
  :func:`reduce_from` then :func:`copy_to` (every rank reads all of Δt's,
  B's and C's inputs), and ``out_proj``'s rows into :func:`reduce_from`.

A region's weights are stored in the reference's blocks and computed in
the blocks of its ``sharding.Split``: :func:`fill_block` moves a rank's
compute block out of the ranks' storage blocks, :func:`storage_grad` its
gradient back (summed where ranks share a block).

On a region of one rank every collective is the identity, so the result
is the plain computation's bit for bit.
"""
from __future__ import annotations

import functools
import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import HeadSplit, Split, even_ranges


class Region(NamedTuple):
    """The 'model' axis's process group, its size and this rank's index
    in it (its coordinate: the index of its blocks)."""
    group: Any
    size: int
    rank: int


def model_region(mesh) -> Region:
    """The 'model' axis of the ``DeviceMesh`` ``mesh`` as this rank's
    :class:`Region`."""
    return Region(mesh.get_group("model"),
                  mesh.size(mesh.mesh_dim_names.index("model")),
                  mesh.get_local_rank("model"))


class Block(NamedTuple):
    """A rank's block of a tensor: the range [lo, hi) of its axis
    ``dim``."""
    dim: int
    lo: int
    hi: int


def narrow(t: torch.Tensor, block: Optional[Block]) -> torch.Tensor:
    """``t``'s ``block`` (a view), or ``t`` where it is None."""
    return t if block is None else t.narrow(block.dim, block.lo,
                                            block.hi - block.lo)


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


def _exchange(pieces: Sequence[List[torch.Tensor]], shapes, region: Region,
              like: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """The tensors ``pieces[q]`` sent to rank q (flattened, in order);
    returns what each rank q sent here as a tensor of ``shapes[q]``, None
    where it sent nothing (one ``all_to_all_single`` with split sizes; no
    gradient). ``like`` gives the type of an empty send."""
    sizes = [math.prod(s) for s in shapes]
    flat = [p.reshape(-1) for parts in pieces for p in parts]
    send = torch.cat(flat) if flat else like.new_empty(0)
    recv = send.new_empty(sum(sizes))
    dist.all_to_all_single(recv, send, sizes,
                           [sum(p.numel() for p in parts) for parts in pieces],
                           group=region.group)
    return [t.view(s) if size else None
            for t, s, size in zip(recv.split(sizes), shapes, sizes)]


def _clip(ranges, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The parts of ``ranges`` inside [lo, hi), in order."""
    return [(max(a, lo), min(b, hi)) for a, b in ranges
            if max(a, lo) < min(b, hi)]


def _parts(t: torch.Tensor, dim: int, ranges, at: int = 0
           ) -> List[torch.Tensor]:
    """``t``'s ranges (shifted by -``at``) along ``dim``."""
    return [t.narrow(dim, a - at, b - a) for a, b in ranges]


def _cat(tensors, dim: int) -> torch.Tensor:
    """``tensors`` (None where a rank sent nothing) concatenated."""
    return torch.cat([t for t in tensors if t is not None], dim)


def _resized(shape, dim: int, n: int) -> tuple:
    return tuple(n if i == dim else s for i, s in enumerate(shape))


def _length(ranges) -> int:
    return sum(b - a for a, b in ranges)


def _is_storage(split: Split, src: int, C: int, n: int) -> bool:
    """Whether each rank's compute block is its storage block (of ``C``
    along ``src``)."""
    return n == 1 or (src == split.dim
                      and split.ranges == even_ranges(C * n, n))


def fill_block(local: torch.Tensor, src: Optional[int], split: Split,
               region: Region) -> torch.Tensor:
    """This rank's compute block of a weight (along ``split.dim``, its
    ``split.ranges``) from its storage block ``local``: whole over every
    axis but 'model', split evenly over it along ``src`` (None: whole).
    Ranges that other ranks store are moved by an all-to-all; no rank
    holds the weight whole."""
    n, r, dim, ranges = region.size, region.rank, split.dim, split.ranges
    if src is None:
        return torch.cat(_parts(local, dim, ranges[r]), dim)
    C = local.shape[src]
    if _is_storage(split, src, C, n):
        return local
    if src == dim:              # the ranges cut storage's blocks
        lo = r * C
        pieces = [_parts(local, dim, _clip(ranges[q], lo, lo + C), lo)
                  for q in range(n)]
        shapes = [_resized(local.shape, dim, _length(
            _clip(ranges[r], q * C, (q + 1) * C))) for q in range(n)]
        return _cat(_exchange(pieces, shapes, region, local), dim)
    # stored split along another dimension (a MoE's wi / wg: d stored,
    # experts computed; Mamba's x_proj: its outputs stored, rows computed)
    pieces = [_parts(local, dim, ranges[q]) for q in range(n)]
    shapes = [_resized(local.shape, dim, _length(ranges[r]))] * n
    return _cat(_exchange(pieces, shapes, region, local), src)


def _within(t: torch.Tensor, dim: int, ranges, lo: int, hi: int
            ) -> List[torch.Tensor]:
    """Of ``t``, ``ranges`` concatenated along ``dim``, the parts that lie
    in [lo, hi)."""
    parts, o = [], 0
    for a, b in ranges:
        parts += [t.narrow(dim, o + x - a, y - x)
                  for x, y in _clip([(a, b)], lo, hi)]
        o += b - a
    return parts


def storage_grad(g: torch.Tensor, src: Optional[int], split: Split,
                 region: Region, whole) -> torch.Tensor:
    """The gradient of this rank's storage block of a weight of shape
    ``whole`` (whole over every axis but 'model', split evenly over it
    along ``src``; None: whole) from each rank's gradient ``g`` of its
    compute block: :func:`fill_block`'s inverse, the parts that ranks
    share (a KV head that several ranks' query heads read) summed in rank
    order."""
    n, r, dim, ranges = region.size, region.rank, split.dim, split.ranges
    shape = list(whole)
    if src is not None:
        shape[src] //= n
        if _is_storage(split, src, shape[src], n):
            return g
    out = g.new_zeros(shape)

    def add(piece, parts, at=0):
        o = 0
        for a, b in parts:
            out.narrow(dim, a - at, b - a).add_(piece.narrow(dim, o, b - a))
            o += b - a

    if src is None:             # stored whole over 'model'
        add(g, ranges[r])
        return all_reduce(out, (region.group,))
    C = shape[src]
    if src == dim:
        pieces = [_within(g, dim, ranges[r], q * C, (q + 1) * C)
                  for q in range(n)]
        mine = [_clip(ranges[q], r * C, (r + 1) * C) for q in range(n)]
        shapes = [_resized(shape, dim, _length(m)) for m in mine]
        for m, piece in zip(mine, _exchange(pieces, shapes, region, g)):
            if piece is not None:
                add(piece, m, r * C)
        return out
    pieces = [[g.narrow(src, q * C, C)] for q in range(n)]
    shapes = [_resized(shape, dim, _length(ranges[q])) for q in range(n)]
    for q, piece in enumerate(_exchange(pieces, shapes, region, g)):
        add(piece, ranges[q])
    return out


def seq_range(max_seq: int, region: Optional[Region]) -> Tuple[int, int]:
    """This rank's positions [lo, hi) of a ``max_seq``-position cache
    (the self K/V's, or the T tokens of the cross K/V): rank r's
    contiguous near-equal range (``even_ranges``; the last rank's ends at
    ``max_seq``), all of them outside a region. Where the axis does not
    divide ``max_seq`` the reference falls back to splitting the head dim;
    the port keeps the near-equal ranges, which move the same bytes and
    keep every rank's (o, lse) a partial over whole heads."""
    if region is None:
        return 0, max_seq
    (lo, hi), = even_ranges(max_seq, region.size)[region.rank]
    return lo, hi


def _first_held(heads: HeadSplit) -> List[Tuple[int, int]]:
    """The KV heads [lo, hi) of which each rank is the first holder (the
    ranks that share a KV head hold the same values of it)."""
    out, done = [], 0
    for a, b in heads.kv:
        out.append((max(a, done), max(b, done)))
        done = max(b, done)
    return out


def seq_block(k: torch.Tensor, v: torch.Tensor, heads: Optional[HeadSplit],
              max_seq: int, region: Region
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A prefill's (k, v), each (B, S, H, D), at this rank's KV heads
    (``heads`` the region's split of them; None: all of them, the same on
    every rank) -> this rank's positions [lo, min(hi, S)) of every KV
    head (:func:`seq_range`), each (B, L, Hkv, D). Each KV head's
    positions come from its first holder, in one ``all_to_all_single``
    (no gradient); a rank whose block starts at or past S gets (B, 0,
    Hkv, D)."""
    lo, hi = seq_range(max_seq, region)
    B, S, _, D = k.shape
    if heads is None:
        return k[:, lo:min(hi, S)], v[:, lo:min(hi, S)]
    n, r = region.size, region.rank
    held = _first_held(heads)
    a, _ = heads.kv[r]
    h0, h1 = held[r]
    pieces = [[t[:, min(x, S):min(y, S), h0 - a:h1 - a] for t in (k, v)]
              for (x, y), in even_ranges(max_seq, n)]
    L = max(0, min(hi, S) - lo)
    shapes = [(2, B, L, y - x, D) for x, y in held]
    got = [t for t in _exchange(pieces, shapes, region, k) if t is not None]
    Hkv = held[-1][1]
    if not got:
        empty = k.new_empty((B, L, Hkv, D))
        return empty, empty
    kv = torch.cat(got, dim=3)
    return kv[0], kv[1]


@functools.lru_cache(maxsize=64)
def _head_index(heads: HeadSplit, width: int, n_kv: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ranks, slots) of the gathered (n, B, width + 2 n_kv, D) buffer that
    hold the query heads, then the KV heads' k, then their v, each from
    its first holder (``n_kv`` 0: the query heads alone)."""
    ranks, slots = [], []
    for q, (a, b) in enumerate(heads.q):
        ranks += [q] * (b - a)
        slots += range(b - a)
    for off in ((width, width + n_kv) if n_kv else ()):
        for q, (a, b) in enumerate(_first_held(heads)):
            ranks += [q] * (b - a)
            slots += range(off + a - heads.kv[q][0], off + b - heads.kv[q][0])
    return (torch.tensor(ranks, device=device),
            torch.tensor(slots, device=device))


def gather_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 heads: HeadSplit, region: Region
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A decode step's q (B, Hq_r, D) and new k, v (B, Hkv_r, D) at this
    rank's heads -> whole (B, Hq, D), (B, Hkv, D), (B, Hkv, D), the same
    on every rank: one all-gather of each rank's q (padded to the most
    query heads a rank holds), k and v, a KV head that ranks share taken
    from its first holder (no gradient)."""
    width = max(b - a for a, b in heads.q)
    send = torch.cat([_padded(q, width), k, v], dim=1)
    out = _all_gather(send, region)
    ranks, slots = _head_index(heads, width, k.shape[1], send.device)
    whole = out[ranks, :, slots].transpose(0, 1)       # (B, heads, D)
    Hq, Hkv = heads.q[-1][1], _first_held(heads)[-1][1]
    return whole[:, :Hq], whole[:, Hq:Hq + Hkv], whole[:, Hq + Hkv:]


def _padded(q: torch.Tensor, width: int) -> torch.Tensor:
    """``q`` (..., H_r, D) padded with zero heads to ``width``."""
    pad = width - q.shape[-2]
    return q if not pad else torch.cat(
        [q, q.new_zeros(q.shape[:-2] + (pad, q.shape[-1]))], dim=-2)


def gather_query(q: torch.Tensor, heads: HeadSplit, region: Region
                 ) -> torch.Tensor:
    """A cross-attention decode step's q (..., Hq_r, D) at this rank's
    query heads -> whole (..., Hq, D), the same on every rank: one
    all-gather (padded to the most query heads a rank holds; no gradient).
    Cross-attention writes no k or v at decode."""
    width = max(b - a for a, b in heads.q)
    out = _all_gather(_padded(q, width).contiguous(), region)
    ranks, slots = _head_index(heads, width, 0, q.device)
    return torch.movedim(out[ranks, ..., slots, :], 0, -2).contiguous()


def merge(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Blocks' partial results o (n, B, H, D) f32 and their log-sum-exps
    lse (n, B, H) -> the attention over all the blocks, (B, H, D) f32:
    m = max lse, w = exp(lse - m), sum w o / sum w, over the blocks in
    order; zeros where every block was empty (lse -inf). One block gives
    its o bit for bit (w = exp(0) = 1)."""
    m = lse.amax(0)
    w = torch.exp(lse - torch.where(m == float("-inf"), 0.0, m))
    den = w.sum(0)[..., None]
    num = (w[..., None] * o).sum(0)
    return torch.where(den > 0, num / den, 0.0)


def merge_partials(o: torch.Tensor, lse: torch.Tensor, region: Region
                   ) -> torch.Tensor:
    """Each rank's partial decode result over its block of the cache, o
    (..., H, D) f32 and lse (..., H) f32 (``ops.gqa_decode_partial``, or
    ``layers._attention_partial`` over a block of cross K/V) -> the
    attention over the whole cache (..., H, D) f32, the same on every
    rank: one all-gather of (..., H, D + 1) a rank, then :func:`merge` in
    rank order (its bits do not depend on a collective's reduction
    order)."""
    out = _all_gather(torch.cat([o, lse[..., None]], dim=-1), region)
    return merge(out[..., :-1], out[..., -1])


def _all_gather(x: torch.Tensor, region: Region) -> torch.Tensor:
    """Each rank's contiguous ``x`` stacked in rank order, (n,) +
    x.shape."""
    out = x.new_empty((region.size * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=region.group)
    return out.unflatten(0, (region.size, -1))


def copy_to(x: torch.Tensor, region: Optional[Region]) -> torch.Tensor:
    """The input of a region: ``x`` forward; the gradient summed over the
    group backward (each rank's products see part of the work)."""
    return x if region is None else _CopyTo.apply(x, region)


def reduce_from(x: torch.Tensor, region: Optional[Region]) -> torch.Tensor:
    """The output of a region: ``x`` summed over the group forward (each
    rank's partial sum); the gradient as it is backward."""
    return x if region is None else _ReduceFrom.apply(x, region)


def gather_dim(x: torch.Tensor, dim: int, region: Region) -> torch.Tensor:
    """Each rank's block ``x`` concatenated along ``dim`` in rank order,
    the same on every rank: one all-gather (forward only)."""
    return torch.cat(_all_gather(x.contiguous(), region).unbind(0), dim)


def gather_vocab(logits: torch.Tensor, region: Optional[Region]
                 ) -> torch.Tensor:
    """The whole (..., V) logits from each rank's (..., V / size) slice
    of the vocabulary (rank r's columns the r-th), all-gathered; forward
    only (a serving step takes no gradient)."""
    return logits if region is None else gather_dim(logits, -1, region)


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
