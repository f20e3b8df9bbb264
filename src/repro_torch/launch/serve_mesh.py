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
``sharding.cache_specs`` lays it out, every leaf of it (``make_cache``):

* the self-attention K/V hold every KV head at the rank's positions, the
  sequence split over 'model' in contiguous near-equal ranges
  (``tensor_parallel.seq_range``). Prefill sends each KV head's positions
  from its first holder to the rank whose block holds them (one
  all-to-all a layer). A decode step gathers the new token's q, k and v
  whole over 'model' (the reference's new-token all-gather), the rank
  whose block holds a row's position writes it, each rank runs the decode
  kernel's partial mode over its block for every query head, and one
  all-gather of the ranks' (o, lse) merges them; the rank's query heads
  then go through its rows of ``wo``. A self-attention module that is not
  a region (whisper-tiny's 6 heads on 16 ranks) computes its q, k and v
  whole and holds its cache split all the same.
* The cross-attention K/V (vision's patches, whisper's frames) likewise
  hold every KV head at the rank's positions of their T tokens: prefill
  attends the whole K/V it has just computed and keeps the rank's block
  (one all-to-all where the KV heads split, else a slice); a decode step
  gathers q whole (one all-gather), attends the block for every query
  head and merges the ranks' (o, lse) (one all-gather).
* Mamba's state holds the rank's channels.
* xLSTM's states split over 'model' exactly when the batch's rows do not
  (:meth:`rows`): where the rows split over the whole mesh each rank has
  rows of its own and holds their states whole, at the spec's bytes a
  rank; where the 'model' ranks share rows (a batch the mesh does not
  divide) each holds its block of every state on the spec's axis
  (``xlstm.state_blocks``) and a decode step computes on it: the mLSTM on
  its heads or its value columns of C, which is never gathered (n and h
  all-gathered, 2 a layer), the sLSTM on its four blocks gathered whole
  (1 a layer). Prefill runs the layer whole (its weights are whole) and
  keeps the blocks.

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
  reference's input specs: the whole mesh for ``tp_friendly=False``
  archs where it divides them); each step takes this rank's rows.
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

import contextlib
from typing import Optional

import torch

from .._device import Device, resolve
from ..models import lm
from ..models import sharding as shard
from ..models import tensor_parallel as TP
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
        #: xLSTM's: the 'model' axis that splits the states, and whether
        #: it splits them for the batch :meth:`rows` was last given (None
        #: before it)
        self.state_region: Optional[TP.Region] = None
        self.split_states: Optional[bool] = None
        if any(m in ("mlstm", "slstm") for m, _ in cfg.pattern):
            self.state_region = TP.model_region(mesh)

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
        for tp_friendly=False archs). It also sets the layout of xLSTM's
        states for the steps that follow (``split_states``): split over
        'model' unless the rows split over it (a 'model' axis of one rank
        splits nothing, so a world of one splits the states, into
        themselves)."""
        dp = shard.best_dp_prefix(self.mesh, x.shape[0],
                                  full_dp=not self.cfg.tp_friendly)
        if self.state_region is not None:
            self.split_states = (self.state_region.size == 1
                                 or "model" not in (dp or ()))
        index, n = shard.dp_coordinate(self.mesh, dp)
        b = x.shape[0] // n
        return x[index * b:(index + 1) * b]

    def cache_region(self) -> Optional[TP.Region]:
        """The region a step's cache is laid out over: the regions' one,
        or xLSTM's 'model' axis where it splits the states (None where the
        rows split over it)."""
        if self.state_region is None:
            return self.region
        if self.split_states is None:
            raise RuntimeError(f"{self.cfg.name}: the layout of its states "
                               f"follows the batch's rows; call rows() on "
                               f"the global batch first")
        return self.state_region if self.split_states else None

    def make_cache(self, batch: int, max_seq: int,
                   kv_len: Optional[torch.Tensor] = None,
                   cross_tokens: Optional[int] = None) -> lm.Cache:
        """An empty cache of ``batch`` rows, this rank's block of every
        leaf (``lm.make_cache(tp=)``): its positions of ``max_seq`` and of
        the cross tokens at every KV head, its Mamba channels, its blocks
        of the xLSTM states where the 'model' ranks share the rows."""
        return lm.make_cache(self.cfg, batch, max_seq, self.device,
                             kv_len=kv_len, cross_tokens=cross_tokens,
                             tp=self.cache_region())

    @contextlib.contextmanager
    def _regions(self, model):
        """The regions of :class:`sharding.MeshParams`, and the xLSTM
        modules' 'model' axis where it splits their states; cleared on
        the way out."""
        region = (self.cache_region() if self.state_region is not None
                  else None)
        mods = ([m for m in model.modules()
                 if isinstance(m, (lm.MLSTM, lm.SLSTM))]
                if region is not None else [])
        with super()._regions(model):
            for mod in mods:
                mod.tp = region
            try:
                yield
            finally:
                for mod in mods:
                    mod.tp = None

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
