"""Carry the reference's state across from numpy.

For the routing loop the "weights" are the evaluator's tables, the cluster
arrays and the optimizer state. Each converter takes ``{field: np.ndarray}``
— what ``repro``'s ``EvalTables._asdict()``, ``ClusterArrays.numpy()
._asdict()`` and ``NSGA2State._asdict()`` give after ``np.asarray`` — keeps
the fields the port has, and returns the port's tensors on ``device`` with
their dtypes. For the serving model, ``lm_params_from_numpy`` and
``cache_from_numpy`` take the reference's ``lm.init`` pytree and decode
``Cache`` with numpy leaves (``jax.tree.map(np.asarray, ...)``), and
``kv_store_from_numpy`` a paged KV store's pools and its logical cache.
Numpy in, tensors out; nothing of ``repro`` is imported.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import Device, resolve, tensors
from .cluster.spec import ClusterArrays
from .core.fitness import EvalTables
from .core.nsga2 import NSGA2State
from .models import lm
from .models.config import ModelConfig
from .serving.kvcache import CacheStats, PagedKVCache, PagedKVStore, _TrieNode


def tables_from_numpy(d: Mapping[str, np.ndarray],
                      device: Device = None) -> EvalTables:
    return tensors(EvalTables, d, device)


def arrays_from_numpy(d: Mapping[str, np.ndarray],
                      device: Device = None) -> ClusterArrays:
    return tensors(ClusterArrays, d, device)


def state_from_numpy(d: Mapping[str, np.ndarray],
                     device: Device = None) -> NSGA2State:
    """An NSGA2State from genomes, F, F_raw, violation, rank and crowd (and
    the generation counter, 0 when absent)."""
    dev = resolve(device)
    parts = {f: torch.as_tensor(np.array(d[f])).to(dev)
             for f in NSGA2State._fields if f != "generation"}
    return NSGA2State(**parts,
                      generation=int(np.asarray(d.get("generation", 0))))


def tensor_from_numpy(a: np.ndarray, device: Device = None) -> torch.Tensor:
    """A tensor with ``a``'s values and dtype; numpy's ``bfloat16`` (from
    ``ml_dtypes``, as JAX hands it out) is carried over bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve(device))


def _layer(leaf, i: int):
    """Entry ``i`` of a leaf stacked over layers (of each array of a dict
    leaf, such as an optimizer's ``{"q", "s"}``)."""
    if isinstance(leaf, Mapping):
        return {k: np.asarray(v)[i] for k, v in leaf.items()}
    return leaf[i]


def _lm_entries(model: lm.LM, cfg: ModelConfig):
    """(port parameter, reference path, layer index) of every parameter of
    ``model``: the keys that reach its leaf in the reference's ``lm.init``
    pytree, and its entry along a leaf stacked over layers (None for a leaf
    that is not stacked)."""
    def module(mod, prefix, i=None):
        for attr, path in mod.REF.items():
            dst = getattr(mod, attr)
            if dst is not None:
                yield dst, prefix + path, i

    def block(blk: lm.Block, prefix, i: int):
        for name in ("norm1", "mixer", "mixer2", "norm1b", "norm2", "ffn"):
            mod = getattr(blk, name)
            if mod is not None:
                yield from module(mod, prefix + (name,), i)

    yield model.embed, ("embed", "table"), None
    if model.head is not None:
        yield model.head, ("head", "table"), None
    yield from module(model.final_norm, ("final_norm",))
    P = len(cfg.pattern)
    for li, blk in enumerate(model.blocks):
        yield from block(blk, ("blocks", li % P), li // P)
    if model.encoder is not None:
        yield model.encoder.pos, ("encoder", "pos"), None
        for i, blk in enumerate(model.encoder.blocks):
            yield from block(blk, ("encoder", "blocks"), i)
        yield from module(model.encoder.final_norm, ("encoder", "final_norm"))


def _lm_leaves(model: lm.LM, cfg: ModelConfig, tree: Mapping[str, Any],
               whole: bool = False):
    """(port parameter, reference leaf) pairs: the leaf of ``tree`` (laid
    out as the reference's ``lm.init`` pytree) that holds each parameter of
    ``model``, sliced to its layer (with ``whole``, the stacked leaf as it
    is). ``tree`` may be any pytree of that layout, such as gradients or
    an optimizer's moments."""
    for dst, path, i in _lm_entries(model, cfg):
        src = tree
        for key in path:
            src = src[key]
        yield dst, (src if i is None or whole else _layer(src, i))


def lm_ref_paths(model: lm.LM, cfg: ModelConfig
                 ) -> Dict[str, Tuple[str, bool]]:
    """{parameter name: (its reference path, stacked)}: the path joins the
    keys of the reference's ``lm.init`` pytree with "/" (list indices
    included, as ``repro.models.sharding`` walks it), and ``stacked`` says
    that the reference's leaf stacks this parameter with others along a
    leading axis (the periods of the block pattern, or the encoder's
    layers)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(dst)]: ("/".join(map(str, path)), i is not None)
            for dst, path, i in _lm_entries(model, cfg)}


def lm_params_from_numpy(params_np: Mapping[str, Any], cfg: ModelConfig,
                         device: Device = None) -> lm.LM:
    """The port's ``LM`` from the reference's ``lm.init`` pytree: ``embed``,
    ``final_norm``, ``head``, ``blocks`` (one dict per pattern position,
    its leaves stacked over the periods: layer ``li`` is entry ``li //
    len(pattern)`` of position ``li % len(pattern)``) and ``encoder``
    (``pos``, ``blocks`` stacked over its layers, ``final_norm``). Each
    module's ``REF`` names its leaves; every mixer, the MoE router and
    experts, tied heads and LayerNorm biases come across. Values and dtypes
    are kept exactly."""
    model = lm.LM(cfg, device)
    for dst, src in _lm_leaves(model, cfg, params_np):
        src = tensor_from_numpy(src, model.device)
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"shape/dtype {tuple(src.shape)} {src.dtype}, "
                             f"want {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    return model


def lm_named_from_numpy(tree_np: Mapping[str, Any], cfg: ModelConfig,
                        model: lm.LM) -> Dict[str, np.ndarray]:
    """A pytree laid out as the reference's ``lm.init`` parameters (its
    gradients, say), as ``{name: array}`` over ``model.named_parameters()``,
    each array sliced to its layer."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(dst)]: np.asarray(src)
            for dst, src in _lm_leaves(model, cfg, tree_np)}


def _to_tensors(tree, device: torch.device):
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def opt_state_from_numpy(state_np: Mapping[str, Any], device: Device = None,
                         cfg: Optional[ModelConfig] = None,
                         model: Optional[lm.LM] = None) -> Dict[str, Any]:
    """The port's optimizer state (``training.optim``) from the reference's,
    numpy leaves, for each of the three optimizers: ``adamw`` (``m``,
    ``v``), ``adamw8bit`` (``m``, ``v`` of ``{"q", "s"}``), ``adafactor``
    (``f`` of ``{"vr", "vc"}`` or ``{"v"}``), with ``step`` and ``gnorm``.

    Without ``cfg`` the parameters are a flat ``{name: array}`` dict on
    both sides and the state carries across as it is. With ``cfg`` and
    ``model`` the reference's state is over its ``lm.init`` pytree and is
    re-keyed by the port's parameter names: ``m`` and ``v`` each leaf
    sliced to its layer, adafactor's ``f`` each stacked leaf whole under
    its stack's name (``lm.param_stacks``), as the port's adafactor keeps
    it. A leaf shaped otherwise than the port keeps it raises
    ``ValueError``."""
    dev = resolve(device if model is None else model.device)
    out: Dict[str, Any] = {
        k: tensor_from_numpy(state_np[k], dev) for k in ("step", "gnorm")}
    params = dict(model.named_parameters()) if cfg is not None else None
    for key in ("m", "v", "f"):
        if key not in state_np:
            continue
        if cfg is None:
            out[key] = _to_tensors(state_np[key], dev)
            continue
        names = {id(p): n for n, p in params.items()}
        stacks = lm.param_stacks(cfg, params) if key == "f" else {}
        stack_of = {n: s for s, members in stacks.items() for n in members}
        tree = {}
        for dst, src in _lm_leaves(model, cfg, state_np[key],
                                   whole=key == "f"):
            name = names[id(dst)]
            tree[stack_of.get(name, name)] = _to_tensors(src, dev)
        for name, st in tree.items():
            p = params[name]
            if key != "f":
                want = (p.shape if not isinstance(st, dict) else
                        {"q": p.shape, "s": p.shape[:-1]
                         + (-(-p.shape[-1] // min(256, p.shape[-1])),)})
            else:
                shape = ((len(stacks[name]),) if name in stacks
                         else ()) + p.shape
                want = ({"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
                        if len(shape) >= 2 else {"v": shape})
            got = (st.shape if not isinstance(st, dict)
                   else {k: t.shape for k, t in st.items()})
            if got != want:
                raise ValueError(f"optimizer state {key} of {name}: shapes "
                                 f"{got}, the port keeps {want}")
        out[key] = tree
    return out


def cache_from_numpy(cache_np, device: Device = None,
                     cfg: Optional[ModelConfig] = None) -> lm.Cache:
    """The port's ``Cache`` from the reference's decode ``Cache`` (numpy
    leaves): ``layer`` and ``cross`` per pattern position, each leaf stacked
    over the periods, and ``kv_len`` (B,). Without ``cfg`` the cache is a
    dense model's (``layer`` = ((k, v),)); with it, every pattern: the
    self-attention K/V restacked in layer order, the recurrent states and
    cross K/V into ``state``."""
    kv_len = tensor_from_numpy(cache_np.kv_len, device).to(torch.int32)
    if cfg is None:
        (k, v), = cache_np.layer
        return lm.Cache(k=tensor_from_numpy(k, device),
                        v=tensor_from_numpy(v, device), kv_len=kv_len)
    P = len(cfg.pattern)
    ks, vs = [], []
    state = {}
    for li, layer in enumerate(lm.layout(cfg)):
        pos, period = li % P, li // P
        if layer.attn >= 0:
            ks.append(np.asarray(cache_np.layer[pos][0])[period])
            vs.append(np.asarray(cache_np.layer[pos][1])[period])
        if layer.group:
            src = (cache_np.cross if layer.group == "cross"
                   else cache_np.layer)[pos]
            for key, leaf in zip(lm.STATE_KEYS[layer.group], src):
                state.setdefault(key, []).append(np.asarray(leaf)[period])
    if ks:
        k = tensor_from_numpy(np.stack(ks), device)
        v = tensor_from_numpy(np.stack(vs), device)
    else:   # no self-attention: the empty stack (its Smax is moot)
        k = v = lm.make_cache(cfg, int(kv_len.shape[0]), 1, device).k
    return lm.Cache(k=k, v=v, kv_len=kv_len, state={
        key: tensor_from_numpy(np.stack(leaves), device)
        for key, leaves in state.items()})


def paged_cache_from(ref_cache) -> PagedKVCache:
    """A copy of a reference ``PagedKVCache`` (read through its attributes:
    ``pool.free/ref/lru``, ``index.root``, ``stats``): the same free list,
    refcounts, LRU order, radix tree (children in insertion order) and
    counters."""
    c = PagedKVCache(ref_cache.pool.n_blocks, ref_cache.block_size)
    c.pool.free = [int(b) for b in ref_cache.pool.free]
    c.pool.ref = np.array(ref_cache.pool.ref, np.int32)
    c.pool.lru = OrderedDict((int(b), None) for b in ref_cache.pool.lru)

    def copy(src, dst) -> None:
        for key, child in src.children.items():
            node = _TrieNode(parent=dst, key=tuple(key), block=int(child.block))
            dst.children[node.key] = node
            c.index._by_block[node.block] = node
            copy(child, node)

    copy(ref_cache.index.root, c.index.root)
    c.stats = CacheStats(**dataclasses.asdict(ref_cache.stats))
    return c


def kv_store_from_numpy(pools_np: Sequence[Tuple[np.ndarray, np.ndarray]],
                        cfg: ModelConfig, device: Device = None,
                        ref_cache=None) -> PagedKVStore:
    """The port's ``PagedKVStore`` from a reference store's pools — one
    ``(k, v)`` pair for the dense pattern, each ``(n_layers, n_blocks,
    block_size, Hkv, D)`` (``[tuple(map(np.asarray, p)) for p in
    store.pools]``) — with values and dtype kept, and its logical cache
    (``store.cache``) copied by :func:`paged_cache_from` when given."""
    (k, v), = pools_np
    store = PagedKVStore(cfg, k.shape[1], k.shape[2], device)
    for dst, src in ((store.k, k), (store.v, v)):
        t = tensor_from_numpy(src, store.device)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"pool {tuple(t.shape)} {t.dtype}, want "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)
    if ref_cache is not None:
        store.cache = paged_cache_from(ref_cache)
    return store
