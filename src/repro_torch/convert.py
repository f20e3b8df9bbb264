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
from typing import Any, Mapping, Optional, Sequence, Tuple

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
    dev = model.device

    def put(dst: torch.Tensor, src) -> None:
        src = tensor_from_numpy(src, dev)
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"shape/dtype {tuple(src.shape)} {src.dtype}, "
                             f"want {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)

    def put_module(mod, tree, i=None) -> None:
        for attr, path in mod.REF.items():
            dst = getattr(mod, attr)
            if dst is None:
                continue
            src = tree
            for key in path:
                src = src[key]
            put(dst, src if i is None else src[i])

    def put_block(blk: lm.Block, tree, i: int) -> None:
        for name in ("norm1", "mixer", "mixer2", "norm1b", "norm2", "ffn"):
            mod = getattr(blk, name)
            if mod is not None:
                put_module(mod, tree[name], i)

    put(model.embed, params_np["embed"]["table"])
    if model.head is not None:
        put(model.head, params_np["head"]["table"])
    put_module(model.final_norm, params_np["final_norm"])
    P = len(cfg.pattern)
    for li, blk in enumerate(model.blocks):
        put_block(blk, params_np["blocks"][li % P], li // P)
    if model.encoder is not None:
        enc = params_np["encoder"]
        put(model.encoder.pos, enc["pos"])
        for i, blk in enumerate(model.encoder.blocks):
            put_block(blk, enc["blocks"], i)
        put_module(model.encoder.final_norm, enc["final_norm"])
    return model


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
