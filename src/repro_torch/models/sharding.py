"""Sharding rules: the counterpart of ``repro.models.sharding``.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension split
over several axes, the first the major one), as JAX's ``PartitionSpec``
reads. The rules are pure shape logic over a mesh's axis names and sizes:
an :class:`AbstractMesh` (names and sizes, no process group, as JAX's
``AbstractMesh``) or a ``torch.distributed.device_mesh.DeviceMesh``.
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model')
multi-pod. DP axis = ('pod', 'data') when the pod axis exists.

Training (2-D sharding, MaxText-style):
  * column-parallel weights (d_in, d_out): ('data', 'model');
  * row-parallel weights: ('model', 'data');
  * MoE experts (E, d, ff): ('model', 'data', None);
  * embeddings (V, d): ('model', 'data') (vocab-parallel);
  * optimizer state inherits the parameter's spec
    (``launch.dryrun.opt_state_specs``).

Serving: weights are replicated over 'data' for models under
:data:`BIG_MODEL_B` parameters and FSDP-sharded over it above.

KV caches (B, S, Hkv, hd): batch over DP and the sequence over 'model'
(head_dim when S does not divide). Rules match on the parameter's path in
the reference's ``lm.init`` pytree, replicating wherever an axis does not
divide the dimension.

The port keeps one tensor per layer where the reference stacks each
position of the block pattern over periods (``blocks/<i>/...``, a leading
period axis; the encoder's layers likewise). ``param_specs`` maps each
parameter to its reference path through ``convert.lm_ref_paths`` and gives
the reference's spec with the stacked axis dropped. Weights keep the
reference's (d_in, d_out) layout, so the rules' axes apply as they are.

What a spec means here: the sharded trainer (``training.trainer``) and
the sharded server (``launch.serve_mesh``) store parameters (and the
trainer its optimizer state) as DTensors with these placements
(:class:`MeshParams`). For compute they fill the weights that a
'model'-parallel region splits (:func:`model_split`: the vocab-parallel
embedding and head, the column- and row-parallel FFN, the experts,
attention's heads, Mamba's channels) over the other axes only, each rank
keeping its compute block (a :class:`Split`), and the rest whole (xLSTM,
norms, routers). The optimizer updates the stored blocks in place
(:func:`block_layout` tells it where a block lies). Activations are each
rank's local tensors, whole over 'model' between regions: :func:`constrain`
is a no-op.

The port's sharded server lays out its whole decode cache as
:func:`cache_specs` does (the reference's GSPMD layout): the self- and
cross-attention K/V hold every KV head at the rank's positions, the
sequence (or the T encoder / patch tokens) over 'model'
(``tensor_parallel.seq_range``; contiguous near-equal ranges where the
axis does not divide it, where the reference falls back to the head dim);
Mamba's state holds the rank's channels; xLSTM's states split on the axis
:func:`cache_model_axis` gives, exactly when the batch's rows do not split
over 'model' (``launch.serve_mesh.ShardedServer.rows``).
"""
from __future__ import annotations

import contextlib
import functools
import re
from typing import (Dict, Iterable, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from .config import ModelConfig

BIG_MODEL_B = 60e9  # params above this FSDP-shard even for serving

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


class AbstractMesh:
    """Axis names and sizes without devices or a process group: what the
    spec rules read. ``shape`` maps each name to its size, in mesh
    order."""

    def __init__(self, axes: Union[Mapping[str, int],
                                   Sequence[Tuple[str, int]]]):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``,
    in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def best_dp_prefix(mesh, dim: int, full_dp: bool) -> Axis:
    """Longest data-parallel axis tuple whose product divides ``dim``."""
    names = _names(mesh)
    axes = [a for a in ("pod", "data") if a in names]
    if full_dp and "model" in names:
        axes.append("model")
    while axes and dim % _axis_size(mesh, tuple(axes)) != 0:
        axes.pop()
    return tuple(axes) if axes else None


def dp_coordinate(mesh, axes) -> Tuple[int, int]:
    """(this rank's index, the count) over the mesh ``axes`` (major
    first): its data-parallel rank when they are the DP axes."""
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    index, count = 0, 1
    for a in axes or ():
        n = mesh.size(names.index(a))
        index, count = index * n + coord[a], count * n
    return index, count


def constrain(x, *axes):
    """The reference's activation sharding constraint: a no-op. Each
    rank's activations are its local tensors (the 'model'-parallel regions
    of ``models.tensor_parallel`` reduce or gather what they split), so
    there is nothing to constrain."""
    return x


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _normal(axis: Axis) -> Axis:
    """An entry as ``PartitionSpec`` normalizes it: a one-name tuple is
    the name, an empty one None."""
    if isinstance(axis, tuple) and len(axis) <= 1:
        return axis[0] if axis else None
    return axis


def _fit(mesh, spec: Spec, shape) -> Spec:
    """Drop axes that do not divide their dimension (replicate instead)."""
    spec = tuple(map(_normal, spec)) + (None,) * (len(shape) - len(spec))
    return tuple(axis if axis is not None and dim % _axis_size(mesh, axis)
                 == 0 else None for dim, axis in zip(shape, spec))


# path-regex -> spec, in the reference's order (the first match wins)
_COL = ("data", "model")     # (d_in, d_out) column-parallel
_ROW = ("model", "data")     # row-parallel
_RULES = [
    # attention / generic dense
    (r".*(wq|wk|wv|wi|wg|up|in_proj|x_proj|ff_up|wx)/w$", _COL),
    (r".*(wo|down|out_proj|ff_down|dt_proj)/w$", _ROW),
    # MoE experts: E over model (EP), d over data (FSDP)
    (r".*ffn/(wi|wg)/w$", ("model", "data", None)),
    (r".*ffn/wo/w$", ("model", None, "data")),
    (r".*router/w$", ("data", None)),
    # embeddings
    (r".*(embed|head)/table$", ("model", "data")),
    (r".*encoder/pos$", (None, "data")),
    # ssm / xlstm specials
    (r".*A_log$", ("model", None)),
    (r".*mixer/D$", ("model",)),
    (r".*conv/w$", (None, "model")),
    (r".*conv/b$", ("model",)),
    (r".*(rz|ri|rf|ro)$", (None, None, None)),
    # norms & biases: replicated
    (r".*", ()),
]


def _match(path: str, mesh, shape, serve_replicate_fsdp: bool) -> Spec:
    """The rule's spec for the reference path ``path`` (list indices
    stripped) of a tensor of ``shape`` (one layer's, unstacked)."""
    for pat, spec in _RULES:
        if re.fullmatch(pat, path):
            axes = tuple(spec)
            if serve_replicate_fsdp:
                axes = tuple(None if a == "data" else a for a in axes)
            return _fit(mesh, axes, shape)
    raise AssertionError(f"no rule for {path}")


def _fsdp_only_spec(mesh, shape, serve_rep: bool) -> Spec:
    """Pure ZeRO-3: shard the first dimension that the flattened (data,
    model) axes divide; replicate the rest. Used for tp_friendly=False
    archs, whose blocks gain nothing from TP. (The reference starts after
    a stacked leaf's period axis; a port tensor has none.)"""
    names = _names(mesh)
    axes_full = tuple(a for a in ("data", "model") if a in names)
    if serve_rep:
        axes_full = tuple(a for a in axes_full if a != "data")
    out = [None] * len(shape)
    for cand in (axes_full, axes_full[:1]):
        if not cand:
            continue
        size = _axis_size(mesh, cand)
        for i in range(len(shape)):
            if shape[i] % size == 0 and shape[i] >= size:
                out[i] = cand if len(cand) > 1 else cand[0]
                return tuple(out)
    return tuple(out)


def param_specs(cfg: ModelConfig, model, mesh, mode: str = "train"
                ) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of ``model`` (an
    ``lm.LM``, on any device, "meta" included). mode: train | serve."""
    from ..convert import lm_ref_paths
    if mode not in ("train", "serve"):
        raise ValueError(f"mode {mode!r}: train or serve")
    serve_rep = (mode == "serve"
                 and cfg.param_counts()["total"] < BIG_MODEL_B)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = {}
    for name, (path, _stacked) in lm_ref_paths(model, cfg).items():
        shape = shapes[name]
        if not cfg.tp_friendly:
            out[name] = _fsdp_only_spec(mesh, shape, serve_rep)
        else:
            out[name] = _match(re.sub(r"/\d+(/|$)", r"\1", path), mesh,
                               shape, serve_rep)
    return out


def cache_specs(cfg: ModelConfig, cache, mesh):
    """Specs for an ``lm.Cache``, with its fields' structure (``state`` a
    dict): batch over DP; KV caches (n, B, S, Hkv, hd) sequence-sharded
    over 'model' (head_dim when S does not divide); recurrent-state inner
    dims over 'model'. The port's ``k``/``v`` stack the self-attention
    layers as the reference stacks periods, and its state leaves put the
    layer first too, so each leaf's spec is the reference's rule on the
    same rank."""
    dp = dp_axes(mesh) or None

    def leaf_spec(x) -> Spec:
        return _cache_leaf_spec(mesh, tuple(x.shape), dp)

    return type(cache)(k=leaf_spec(cache.k), v=leaf_spec(cache.v),
                       kv_len=leaf_spec(cache.kv_len),
                       state={k: leaf_spec(t)
                              for k, t in cache.state.items()})


def _cache_leaf_spec(mesh, shape, dp: Axis) -> Spec:
    """:func:`cache_specs`' rule for one leaf of ``shape``."""
    if len(shape) == 5:          # (n, B, S, Hkv, hd) KV cache, mLSTM's C
        spec = _fit(mesh, (None, dp, "model", None, None), shape)
        if spec[2] is None:      # S not divisible: fall back to hd
            spec = _fit(mesh, (None, dp, None, None, "model"), shape)
        return spec
    if len(shape) == 4:
        return _fit(mesh, (None, dp, None, "model"), shape)
    if len(shape) == 3:
        return _fit(mesh, (None, dp, "model"), shape)
    if len(shape) in (1, 2):
        return _fit(mesh, (dp,), shape) if shape[0] > 1 else ()
    return ()


def cache_model_axis(shape, n: int) -> Optional[int]:
    """The axis of a stacked cache leaf of ``shape`` ((layers, B, ...))
    that :func:`cache_specs` splits over a 'model' axis of n ranks, or
    None where it keeps the leaf whole."""
    spec = _cache_leaf_spec(AbstractMesh({"model": n}), tuple(shape), None)
    return spec.index("model") if "model" in spec else None


def batch_specs(cfg: ModelConfig, batch: Mapping[str, torch.Tensor], mesh
                ) -> Dict[str, Spec]:
    """{key: spec}: each batch tensor's leading dimension over DP."""
    dp = dp_axes(mesh) or None
    return {k: _fit(mesh, (dp,) + (None,) * (len(x.shape) - 1),
                    tuple(x.shape)) for k, x in batch.items()}


def to_placements(device_mesh, spec: Spec):
    """DTensor placements (one per mesh dimension) for ``spec`` on
    ``device_mesh``: a tensor dimension over an axis is ``Shard(dim)`` on
    that mesh dimension, and over a tuple of axes ``Shard(dim)`` on each,
    the first the major one as JAX orders them (so the tuple must follow
    the mesh's order); other mesh dimensions replicate."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]} used twice")
            out[i] = Shard(dim)
    return out


def is_spec(x) -> bool:
    """Whether ``x`` is a spec (a leaf of a specs tree): a tuple of None,
    axis names and tuples of names."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(n, str) for n in a))
        for a in x)


def spec_to_json(spec: Spec) -> list:
    """A spec as the reference's checkpoint manifest writes it: a list,
    each tuple entry a list."""
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def spec_from_json(j) -> Spec:
    return tuple(tuple(a) if isinstance(a, list) else a for a in j)


class Split(NamedTuple):
    """How a 'model'-parallel region fills one of its weights: along
    ``dim``, rank r holds the index ranges ``ranges[r]`` of the whole
    tensor, concatenated in order (ranks may share a range: the KV heads
    that several ranks' query heads read). ``dim`` None: the weight is
    filled whole and acts on the rank's part of the work (qk-norm's gains
    on its heads), so each rank's gradient of it is a partial sum over the
    region."""
    dim: Optional[int]
    ranges: Tuple[Tuple[Tuple[int, int], ...], ...] = ()


def even_ranges(size: int, n: int) -> Tuple[Tuple[Tuple[int, int], ...],
                                             ...]:
    """Rank r's range [r size / n, (r + 1) size / n) of each of n ranks."""
    return tuple(((r * size // n, (r + 1) * size // n),) for r in range(n))


class HeadSplit(NamedTuple):
    """Each rank's query heads and the KV heads they read, as [lo, hi)."""
    q: Tuple[Tuple[int, int], ...]
    kv: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=None)
def head_split(n_heads: int, n_kv_heads: int, n: int
               ) -> Optional[HeadSplit]:
    """Attention's heads over n 'model' ranks, or None (kept whole): a
    split when n <= n_heads and either n_kv_heads % n == 0 or n %
    n_kv_heads == 0. Rank r takes the contiguous query heads [r H / n, (r
    + 1) H / n) (rounded down; a head is never cut) and reads the KV heads
    of their groups: n_kv_heads / n of them, or one that n / n_kv_heads
    ranks share."""
    H, Hkv = n_heads, n_kv_heads
    if not (n <= H and (Hkv % n == 0 or n % Hkv == 0)):
        return None
    G = H // Hkv
    q = tuple((r * H // n, (r + 1) * H // n) for r in range(n))
    kv = tuple((lo // G, (hi - 1) // G + 1) for lo, hi in q)
    for (lo, hi), (a, b) in zip(q, kv):
        # no rank's heads straddle two KV heads: whole groups, or one
        assert b - a == max(1, Hkv // n), (H, Hkv, n, lo, hi)
        assert b - a == 1 or (lo, hi) == (a * G, b * G), (H, Hkv, n, lo, hi)
    return HeadSplit(q, kv)


def model_split(model, mesh) -> Dict[str, Dict[str, Split]]:
    """The 'model'-parallel regions of ``model`` (an ``lm.LM``) on
    ``mesh``: {module name: {parameter name: its :class:`Split`}} for each
    module with ``SPLIT`` dimensions that the 'model' axis splits: the
    LM's embedding and head over the vocabulary, a dense FFN's wi / wg
    columns and wo rows, a MoE's experts (each when the axis divides its
    dimension), and the modules whose ``split_ranges(n)`` gives each
    rank's ranges (attention's heads, Mamba's channels; None keeps the
    module whole); a module's ``PARTIAL`` weights are filled whole. The
    blocks are those of compute, not of storage: the reference's rules
    store a MoE's wi / wg with d over 'model' (the generic column rule
    matches first), and attention's columns where heads do not line up
    with them, so the trainer moves a rank's blocks between other ranks'
    storage (``tensor_parallel.fill_block``)."""
    n = axis_sizes(mesh).get("model", 0)
    out = {}
    for mname, mod in model.named_modules():
        dims = {k: d for k, d in getattr(mod, "SPLIT", {}).items()
                if getattr(mod, k) is not None}
        if not (n and dims):
            continue
        if hasattr(mod, "split_ranges"):
            ranges = mod.split_ranges(n)
        elif all(getattr(mod, k).shape[d] % n == 0 for k, d in dims.items()):
            ranges = {k: even_ranges(getattr(mod, k).shape[d], n)
                      for k, d in dims.items()}
        else:
            ranges = None
        if ranges is None:
            continue
        pre = f"{mname}." if mname else ""
        out[mname] = {pre + k: Split(d, ranges[k]) for k, d in dims.items()}
        out[mname].update({pre + k: Split(None)
                           for k in getattr(mod, "PARTIAL", ())
                           if getattr(mod, k) is not None})
    return out


def fill_placements(device_mesh, model=None):
    """The DTensor placements of a weight filled whole over every mesh
    axis but 'model', over which it keeps the placement ``model`` (its
    storage's 'model' split, which a region's fill starts from); whole
    over every axis without it."""
    from torch.distributed.tensor import Replicate
    return [model if name == "model" and model is not None else Replicate()
            for name in device_mesh.mesh_dim_names]


class BlockLayout(NamedTuple):
    """Where one rank's block lies in the whole tensor: per axis the
    process groups of the mesh dimensions that split it (major first;
    none for a whole axis), the whole size, and the block's first index
    along it."""
    groups: Tuple[tuple, ...]
    whole: Tuple[int, ...]
    offset: Tuple[int, ...]

    @staticmethod
    def whole_of(shape) -> "BlockLayout":
        """The layout of a whole tensor of ``shape`` (no group)."""
        return BlockLayout(((),) * len(shape), tuple(shape),
                           (0,) * len(shape))


def block_layout(device_mesh, spec: Spec, shape) -> BlockLayout:
    """This rank's :class:`BlockLayout` of a tensor of ``shape`` (whole)
    under ``spec`` (a dimension split over several axes: the first the
    major one, as :func:`to_placements` orders them)."""
    from torch.distributed.tensor import Shard
    coord = device_mesh.get_coordinate()
    groups = [[] for _ in shape]
    index, count = [0] * len(shape), [1] * len(shape)
    for i, pl in enumerate(to_placements(device_mesh, spec)):
        if not isinstance(pl, Shard):
            continue
        dim, n = pl.dim, device_mesh.size(i)
        groups[dim].append(device_mesh.get_group(i))
        index[dim], count[dim] = index[dim] * n + coord[i], count[dim] * n
    return BlockLayout(tuple(map(tuple, groups)), tuple(shape),
                       tuple(d // c * j for d, c, j in zip(shape, count,
                                                            index)))


def local_block(tensor: torch.Tensor, device_mesh, spec: Spec
                ) -> torch.Tensor:
    """This rank's block of ``tensor`` (whole, the same on every rank)
    under ``spec``: a view of it (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor.detach(), device_mesh,
                             to_placements(device_mesh, spec),
                             src_data_rank=None).to_local()


def _dtensor(local: torch.Tensor, device_mesh, spec: Spec):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, device_mesh,
                              to_placements(device_mesh, spec),
                              run_check=False)


def shard(tensor: torch.Tensor, device_mesh, spec: Spec):
    """``tensor`` (whole, the same on every rank) as a DTensor with
    ``spec``'s placements, each rank keeping a copy of its own block (no
    communication)."""
    return _dtensor(local_block(tensor, device_mesh, spec).clone(),
                    device_mesh, spec)


def from_local_tree(tree, specs, device_mesh):
    """A dict tree of this rank's blocks as DTensors, each leaf with the
    spec at the same place in ``specs`` (no communication)."""
    if isinstance(tree, dict):
        return {k: from_local_tree(v, specs[k], device_mesh)
                for k, v in tree.items()}
    return _dtensor(tree, device_mesh, specs)


def local_shape(shape, mesh, spec: Spec) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``spec`` (every axis of a fitted spec divides its dimension)."""
    spec = _fit(mesh, spec, shape)
    return tuple(d // _axis_size(mesh, a) for d, a in zip(shape, spec))


class MeshParams:
    """A model's parameters stored on a mesh and filled into the model for
    compute: the storage-and-fill half of the sharded trainer and the
    sharded server.

    ``params`` keeps this rank's blocks ({name: DTensor} with the
    placements of :func:`param_specs` in ``mode``); the model's own
    parameters hold no storage until :meth:`_fill` gives them their values
    as computed: a 'model'-parallel region's weights as this rank's
    compute blocks (``split``, ``region``; ``tensor_parallel.fill_block``
    moves ranges that other ranks store), gathered over the other axes,
    the rest whole. ``peak_bytes["filled"]`` is the most bytes the model's
    parameters have held at once. Without a mesh nothing is stored and
    there is no region."""

    def __init__(self, cfg: ModelConfig, mesh, mode: str,
                 peaks: Sequence[str] = ("filled",)):
        self.mesh = mesh
        self.pspecs: Optional[Dict[str, Spec]] = None
        #: the whole shape of each parameter, by name (on a mesh)
        self.shapes: Optional[Dict[str, tuple]] = None
        #: the stored parameters on a mesh: {name: DTensor}
        self.params: Optional[Dict[str, torch.Tensor]] = None
        #: the 'model'-parallel regions: {module name: {parameter: its
        #: Split}}
        self.split: Dict[str, Dict[str, Split]] = {}
        self.region = None
        if mesh is not None:
            from . import lm
            from . import tensor_parallel as TP
            model = lm.LM(cfg, "meta")
            self.pspecs = param_specs(cfg, model, mesh, mode=mode)
            self.shapes = {n: tuple(p.shape)
                           for n, p in model.named_parameters()}
            if cfg.tp_friendly and "model" in mesh.mesh_dim_names:
                self.split = model_split(model, mesh)
                self.region = TP.model_region(mesh)
        #: each region parameter's Split (the rest is whole)
        self.splits = {k: sp for ds in self.split.values()
                       for k, sp in ds.items()}
        self.peak_bytes = dict.fromkeys(peaks, 0)

    def _fill(self, params, names, whole: bool = False) -> None:
        """Give the model's parameters ``names`` their stored values as
        computed (a region's weights their compute blocks, gathered over
        the other axes, the rest whole), or all whole with ``whole`` (a
        collective: every rank calls it)."""
        with torch.no_grad():
            for k in names:
                p = params[k]
                value = self._model_block(k, whole)
                if p.shape != value.shape:   # first fill, or after a
                    p.data = value.clone()   # gather_model
                    continue
                # the recompute refills a tensor that autograd saved: its
                # values come back unchanged, so its version stays
                with torch.autograd._unsafe_preserve_version_counter(p):
                    p.untyped_storage().resize_(value.nbytes)
                    p.copy_(value)
        self._peak("filled", sum(p.untyped_storage().nbytes()
                                 for p in params.values()))

    def _storage(self, k: str):
        """(placements of ``k``'s storage block over 'model', whole over
        the other axes; the dimension storage splits over 'model', or
        None)."""
        from torch.distributed.tensor import Shard
        pl = self.params[k].placements[self.mesh.mesh_dim_names.index(
            "model")]
        return (fill_placements(self.mesh, pl),
                pl.dim if isinstance(pl, Shard) else None)

    def _model_block(self, k: str, whole: bool = False) -> torch.Tensor:
        """This rank's block of the stored weight ``k`` as computed: its
        region's compute block (``tensor_parallel.fill_block``: ranges
        that other ranks store moved by an all-to-all, so no rank holds
        the weight whole), or whole."""
        from . import tensor_parallel as TP
        t, sp = self.params[k], None if whole else self.splits.get(k)
        if sp is None or sp.dim is None:
            return t.redistribute(self.mesh,
                                  fill_placements(self.mesh)).to_local()
        keep, src = self._storage(k)
        return TP.fill_block(t.redistribute(self.mesh, keep).to_local(), src,
                             sp, self.region)

    def _peak(self, what: str, nbytes: int) -> None:
        self.peak_bytes[what] = max(self.peak_bytes[what], nbytes)

    @staticmethod
    def _release(params, names) -> None:
        """Free the storage of the model's parameters ``names``."""
        for k in names:
            params[k].untyped_storage().resize_(0)

    def _store(self, model) -> None:
        """Keep this rank's blocks of ``model``'s parameters (whole, the
        same on every rank) in ``self.params`` and free the model's."""
        params = dict(model.named_parameters())
        self.params = {k: shard(p, self.mesh, self.pspecs[k])
                       for k, p in params.items()}
        self._release(params, params)

    def gather_model(self, model):
        """``model`` with every parameter filled with its stored whole
        value (a collective)."""
        self._fill(dict(model.named_parameters()), self.params, whole=True)
        return model

    @contextlib.contextmanager
    def _regions(self, model):
        """Set the region on ``model``'s region modules for a step;
        cleared on the way out, whatever happens (the model's single-card
        paths then take none)."""
        mods = [model.get_submodule(m) for m in self.split]
        for mod in mods:
            mod.tp = self.region
        try:
            yield
        finally:
            for mod in mods:
                mod.tp = None

    def _period_filler(self, model, params, skip: Iterable[str] = (),
                       free_previous: bool = True):
        """A ``materialize(blocks)`` hook for ``lm``'s passes: it fills the
        parameters of the period ``blocks`` (but ``skip``), once, and with
        ``free_previous`` first frees the period filled before it."""
        skip = set(skip)
        index = {id(blk): i for i, blk in enumerate(model.blocks)}
        layer: Dict[int, list] = {}
        for k in params:
            if k.startswith("blocks.") and k not in skip:
                layer.setdefault(int(k.split(".")[1]), []).append(k)
        live: Dict[int, list] = {}

        def materialize(blocks):
            key = index[id(blocks[0])]
            if free_previous:
                for other in [o for o in live if o != key]:
                    self._release(params, live.pop(other))
            if key not in live:
                live[key] = [k for blk in blocks
                             for k in layer.get(index[id(blk)], ())]
                if live[key]:
                    self._fill(params, live[key])

        return materialize
