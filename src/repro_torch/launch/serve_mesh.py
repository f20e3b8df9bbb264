"""The sharded serve step: the counterpart of the reference dry run's
``prefill_step`` / ``decode_step`` (``repro.launch.dryrun``), which lower
``lm.prefill`` and ``lm.decode_step`` with the parameters in their serve
placements.

``ShardedServer(cfg, mesh, device)`` stores each parameter in the serve
placements of ``sharding.param_specs(mode="serve")`` (``load``), as this
rank's blocks (``sharding.MeshParams``), and runs ``lm.prefill`` and
``lm.decode_step`` in the mesh's 'model'-parallel regions
(``models.tensor_parallel``): the vocab-parallel embedding and head (the
last logits gathered whole), the column- / row-parallel FFN, the experts,
attention at the rank's query heads (the flash kernel in prefill) and
Mamba at its channels. The decode cache is laid out as the reference's
``sharding.cache_specs`` lays it out: the self-attention K/V hold every KV
head at the rank's positions, the sequence split over 'model' in
contiguous near-equal ranges (``make_cache``; ``tensor_parallel.
seq_range``). Prefill sends each KV head's positions from its first
holder to the rank whose block holds them (one all-to-all a layer). A
decode step gathers the new token's q, k and v whole over 'model' (the
reference's new-token all-gather), the rank whose block holds a row's
position writes it, each rank runs the decode kernel's partial mode over
its block for every query head, and one all-gather of the ranks' (o, lse)
merges them; the rank's query heads then go through its rows of ``wo``.
A self-attention module that is not a region (whisper-tiny's 6 heads on
16 ranks) computes its q, k and v whole and holds its cache split all the
same. Mamba's state holds the rank's channels; cross K/V the rank's KV
heads; mLSTM and sLSTM states are whole.

* A weight whose serve placement is whole over every mesh axis but
  'model', and which a region splits or is whole over 'model' too, gets
  its compute block once, at ``load``, and keeps it (``resident``): every
  ``tp_friendly`` arch below ``sharding.BIG_MODEL_B`` parameters. No step
  fills it.
* The rest is filled for each step and freed after it, the weights of the
  blocks a period of the block pattern at a time: the big archs, whose
  serve placements also split over 'data' (FSDP), and ``tp_friendly=False``
  ones (xLSTM), which have no region and gather their weights whole. This
  is the cost the reference documents for the big archs: an all-gather a
  layer.
* A batch's rows split over the DP axes of its size (:meth:`rows`, the
  reference's input specs); each step takes this rank's rows.
* The regions are set for a step and cleared after it, whatever happens.

Usage, on every rank of an initialized process group::

    mesh = make_host_mesh(model=2)        # device="cpu" for a CPU mesh
    server = ShardedServer(cfg, mesh)     # on the card unless told
    server.load(model)                    # whole, the same on every rank
    logits, cache = server.prefill(server.rows(tokens), max_seq=64)
    logits, cache = server.decode_step(server.rows(next_tokens), cache)

A world of one (a region of one rank) gives ``lm.prefill`` and
``lm.decode_step``'s results bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._device import Device, resolve
from ..models import lm
from ..models import sharding as shard
from ..models.config import ModelConfig


class ShardedServer(shard.MeshParams):
    def __init__(self, cfg: ModelConfig, mesh, device: Device = None):
        self.cfg = cfg
        self.device = resolve(device)
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, server on "
                             f"{self.device}")
        super().__init__(cfg, mesh, "serve")
        self.model: Optional[lm.LM] = None
        #: the parameters filled once at ``load`` and kept
        self.resident: tuple = ()

    def _keeps(self, k: str) -> bool:
        """Whether the stored weight ``k`` computes as stored: whole over
        every axis but 'model', and over 'model' whole or split by its
        region."""
        from torch.distributed.tensor import Replicate
        sp = self.splits.get(k)
        split = sp is not None and sp.dim is not None
        return all(isinstance(pl, Replicate) or (name == "model" and split)
                   for name, pl in zip(self.mesh.mesh_dim_names,
                                       self.params[k].placements))

    def load(self, model: lm.LM) -> None:
        """Store ``model``'s parameters (whole, the same on every rank) as
        this rank's blocks and fill the resident ones with their compute
        blocks (a collective); the model is the server's from now on."""
        self._store(model)
        params = dict(model.named_parameters())
        self.resident = tuple(k for k in params if self._keeps(k))
        self._fill(params, self.resident)
        for k in self.resident:
            del self.params[k]
        self.model = model

    def stored_bytes(self) -> int:
        """Bytes this rank holds between steps: the resident compute
        blocks and the blocks of the rest."""
        params = dict(self.model.named_parameters())
        return (sum(params[k].untyped_storage().nbytes()
                    for k in self.resident)
                + sum(t.to_local().nbytes for t in self.params.values()))

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch ``x`` (dim 0): its block
        over the DP axes that the batch's size divides (the whole mesh's
        for tp_friendly=False archs)."""
        dp = shard.best_dp_prefix(self.mesh, x.shape[0],
                                  full_dp=not self.cfg.tp_friendly)
        index, n = shard.dp_coordinate(self.mesh, dp)
        b = x.shape[0] // n
        return x[index * b:(index + 1) * b]

    def make_cache(self, batch: int, max_seq: int,
                   kv_len: Optional[torch.Tensor] = None,
                   cross_tokens: Optional[int] = None) -> lm.Cache:
        """An empty cache of ``batch`` rows: this rank's positions of
        ``max_seq`` at every KV head, its Mamba channels and cross KV
        heads."""
        return lm.make_cache(self.cfg, batch, max_seq, self.device,
                             kv_len=kv_len, cross_tokens=cross_tokens,
                             tp=self.region)

    def _step(self, fn, *args):
        """``fn(model, cfg, *args, materialize=)`` in the regions, the
        parameters that are not resident filled for it (the blocks' a
        period at a time) and freed after it."""
        model = self.model
        params = dict(model.named_parameters())
        keep = set(self.resident)
        per_step = [k for k in params if k not in keep]
        with torch.no_grad(), self._regions(model):
            try:
                outside = [k for k in per_step
                           if not k.startswith("blocks.")]
                if outside:
                    self._fill(params, outside)
                materialize = (self._period_filler(model, params, keep)
                               if per_step else None)
                return fn(model, self.cfg, *args, materialize=materialize)
            finally:
                self._release(params, per_step)

    def prefill(self, tokens: torch.Tensor, max_seq: Optional[int] = None,
                length: Optional[int] = None,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None):
        """``lm.prefill`` on this rank's rows: (their last logits (B,
        vocab) f32, whole over the vocabulary; their cache, this rank's
        block of it)."""
        return self._step(lm.prefill, tokens, max_seq, length, frames,
                          patches)

    def decode_step(self, token: torch.Tensor, cache: lm.Cache):
        """``lm.decode_step`` on this rank's rows and its cache."""
        return self._step(lm.decode_step, token, cache)
