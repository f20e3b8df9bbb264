"""Paged KV cache with prefix reuse: the counterpart of
``repro.serving.kvcache``.

Three layers, as in the reference:

* :class:`BlockPool` — fixed-size token blocks with a free list, per-block
  reference counts (blocks are *shared* between slots that extend the same
  prefix) and LRU eviction of unreferenced cached blocks;
* :class:`RadixIndex` — a radix tree over block-granular token chunks
  mapping token prefixes to cached block ids; only leaves are evictable;
* :class:`PagedKVStore` — the physical store one ``LLMEngine`` owns: one k
  and one v pool for the whole layer stack, each ``(n_layers, n_blocks,
  block_size, n_kv_heads, head_dim)`` in the model's dtype, plus the logical
  :class:`PagedKVCache`. ``gather`` reads a matched prefix back as the
  contiguous view ``models.lm.prefill_extend`` consumes; ``scatter`` writes
  freshly prefilled blocks into the pool.

The first two, with ``CacheStats`` and ``PagedKVCache``, are pure-Python
copies of the reference's (the port imports nothing of ``repro``); the tests
hold them equal to it under the same random operation sequences.

Reuse is exact up to rounding: K/V at position *j* depend only on tokens
``<= j`` (causal attention, absolute RoPE). As in the reference engine, the
matched prefix is gathered into the slot's contiguous decode cache at
admission; decode over pool-resident pages (the paged decode kernel,
``kernels.paged_attention``) is not wired into the engine.

:class:`FleetKVPools` stacks the pools of a fleet cohort's members into one
k and one v tensor with a leading member axis; each member's store then
works on its own slice of them (``PagedKVStore.attach``), in place.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import Device, resolve
from ..models.config import ModelConfig
from ..models.layers import dtype_of


class BlockPool:
    """Fixed-capacity pool of KV blocks with ref-counted sharing + LRU.

    A block is in exactly one of three states:

    * **free** — on the free list, content meaningless;
    * **active** — ``ref > 0``; pinned by one or more engine slots;
    * **evictable** — ``ref == 0`` but still indexed by the radix tree;
      kept in LRU order and reclaimed when the free list runs dry.
    """

    def __init__(self, n_blocks: int):
        assert n_blocks > 0
        self.n_blocks = n_blocks
        self.free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.ref = np.zeros(n_blocks, np.int32)
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # evictable blocks

    # -- accounting ---------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_evictable(self) -> int:
        return len(self.lru)

    def check_invariants(self) -> None:
        active = int(np.sum(self.ref > 0))
        assert np.all(self.ref >= 0), "negative refcount"
        assert active + self.n_free + self.n_evictable == self.n_blocks, (
            active, self.n_free, self.n_evictable, self.n_blocks)
        assert all(self.ref[b] == 0 for b in self.lru), \
            "referenced block on the LRU list"

    # -- state transitions --------------------------------------------------
    def take_free(self) -> Optional[int]:
        """Pop a free block with ``ref = 1`` (no eviction attempted)."""
        if not self.free:
            return None
        b = self.free.pop()
        self.ref[b] = 1
        return b

    def acquire(self, block: int) -> None:
        """Pin a cached block (a slot starts sharing it)."""
        self.ref[block] += 1
        self.lru.pop(block, None)

    def release(self, block: int, cached: bool) -> None:
        """Unpin; an unreferenced block becomes evictable (if the radix index
        still maps to it) or free (if it was never / no longer cached)."""
        assert self.ref[block] > 0, f"release of unreferenced block {block}"
        self.ref[block] -= 1
        if self.ref[block] == 0:
            if cached:
                self.lru[block] = None
                self.lru.move_to_end(block)
            else:
                self.free.append(block)

    def touch(self, block: int) -> None:
        """LRU bump on a cache hit of an evictable block."""
        if block in self.lru:
            self.lru.move_to_end(block)

    def pop_evictable(self, can_evict) -> Optional[int]:
        """Reclaim the least-recently-used evictable block accepted by
        ``can_evict`` (the radix index only admits leaves). Returns the block
        id with ``ref = 1``, or None if nothing qualifies."""
        for b in self.lru:
            if can_evict(b):
                del self.lru[b]
                self.ref[b] = 1
                return b
        return None


class _TrieNode:
    __slots__ = ("children", "parent", "key", "block")

    def __init__(self, parent: Optional["_TrieNode"] = None,
                 key: Optional[Tuple[int, ...]] = None, block: int = -1):
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}
        self.parent = parent
        self.key = key
        self.block = block


class RadixIndex:
    """Radix tree over block-granular token chunks -> cached block ids.

    Keys are the *token contents* of one block (a ``block_size`` tuple), so
    two prompts share a path exactly as far as their token streams agree in
    whole blocks — the longest-cached-prefix query of vLLM's prefix caching.
    """

    def __init__(self, block_size: int):
        assert block_size > 0
        self.block_size = block_size
        self.root = _TrieNode()
        self._by_block: Dict[int, _TrieNode] = {}

    def _chunks(self, tokens: Sequence[int]):
        bs = self.block_size
        for i in range(0, (len(tokens) // bs) * bs, bs):
            yield tuple(int(t) for t in tokens[i:i + bs])

    @property
    def n_blocks(self) -> int:
        return len(self._by_block)

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Block ids of the longest cached whole-block prefix of ``tokens``."""
        node = self.root
        out: List[int] = []
        for chunk in self._chunks(tokens):
            node = node.children.get(chunk)
            if node is None:
                break
            out.append(node.block)
        return out

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> List[int]:
        """Index the whole-block prefix of ``tokens`` as ``blocks``.

        Existing path nodes keep their canonical block (a racing duplicate
        block stays unindexed and returns to the free list on release).
        Returns the block ids that were newly indexed.
        """
        node = self.root
        added: List[int] = []
        for chunk, blk in zip(self._chunks(tokens), blocks):
            child = node.children.get(chunk)
            if child is None:
                child = _TrieNode(parent=node, key=chunk, block=int(blk))
                node.children[chunk] = child
                self._by_block[int(blk)] = child
                added.append(int(blk))
            node = child
        return added

    def has_block(self, block: int) -> bool:
        return block in self._by_block

    def is_evictable(self, block: int) -> bool:
        """Only leaves may be evicted — an interior block is on the lookup
        path of every cached descendant."""
        node = self._by_block.get(block)
        return node is not None and not node.children

    def remove(self, block: int) -> None:
        node = self._by_block.pop(block)
        assert not node.children, "evicting an interior radix node"
        del node.parent.children[node.key]


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0              # lookups that matched >= 1 block
    hit_tokens: int = 0        # tokens served from cache
    prefill_tokens_total: int = 0
    prefill_tokens_run: int = 0
    evictions: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hits / self.lookups if self.lookups else 0.0
        d["token_hit_rate"] = (self.hit_tokens / self.prefill_tokens_total
                               if self.prefill_tokens_total else 0.0)
        return d


class PagedKVCache:
    """Logical pool + index pair: the allocation protocol the engine drives.

    Lifecycle per admitted request: ``match`` -> ``acquire`` matched blocks ->
    prefill the suffix -> ``allocate`` blocks for new whole-block suffix
    chunks -> ``commit`` the prefix into the index -> (at retire/cancel)
    ``release`` the slot's block table.
    """

    def __init__(self, n_blocks: int, block_size: int):
        self.pool = BlockPool(n_blocks)
        self.index = RadixIndex(block_size)
        self.block_size = block_size
        self.stats = CacheStats()

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached whole-block prefix, capped so at least one token is
        left to prefill (the model needs >= 1 suffix token for logits)."""
        blocks = self.index.match(tokens)
        while blocks and len(blocks) * self.block_size >= len(tokens):
            blocks = blocks[:-1]
        self.stats.lookups += 1
        if blocks:
            self.stats.hits += 1
            self.stats.hit_tokens += len(blocks) * self.block_size
        return blocks

    def acquire(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.pool.acquire(b)

    def allocate(self) -> Optional[int]:
        """One fresh block (ref = 1), evicting an LRU leaf if needed."""
        b = self.pool.take_free()
        if b is not None:
            return b
        b = self.pool.pop_evictable(self.index.is_evictable)
        if b is None:
            return None
        self.index.remove(b)
        self.stats.evictions += 1
        return b

    def commit(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        self.index.insert(tokens, blocks)

    def release(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.pool.release(b, cached=self.index.has_block(b))

    def check_invariants(self) -> None:
        self.pool.check_invariants()
        for b in list(self.pool.lru):
            assert self.index.has_block(b), \
                "evictable block missing from the radix index"


class PagedKVStore:
    """Physical paged K/V tensors for one engine (and the logical cache).

    ``k`` and ``v`` are ``(n_layers, n_blocks, block_size, n_kv_heads,
    head_dim)`` in the model's dtype on ``device``: one pool per layer
    stack, as the reference keeps one per pattern position of its dense
    pattern. Every transfer is one indexed read or write per pool, never one
    per block. Pure-attention patterns only (MoE FFNs included), as in the
    reference: recurrent state and cross-attention K/V are per slot, not
    per prefix position."""

    def __init__(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                 device: Device = None):
        if (not all(m == "attn" for m, _ in cfg.pattern)
                or cfg.encoder is not None or cfg.family in ("audio", "vlm")):
            raise ValueError(f"{cfg.name}: paged KV supports pure-attention "
                             f"block patterns, not {cfg.pattern} "
                             f"({cfg.family})")
        self.cfg = cfg
        self.device = resolve(device)
        self.cache = PagedKVCache(n_blocks, block_size)
        self.block_size = block_size
        shp = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
        self.k = torch.zeros(shp, dtype=dtype_of(cfg), device=self.device)
        self.v = torch.zeros(shp, dtype=dtype_of(cfg), device=self.device)

    def attach(self, fleet: "FleetKVPools", member: int,
               copy: bool = True) -> None:
        """Re-home this store's bytes onto slice ``member`` of a cohort's
        stacked pools: from here on ``k`` and ``v`` are views of that slice,
        and every write below lands there. ``copy`` writes the store's
        current pools into the slice first (a fresh or flushed store zeroes
        it); ``FleetKVPools.stack`` passes False, having stacked them. The
        logical cache (pool, radix index, refcounts) stays per engine."""
        if copy:
            fleet.k[member].copy_(self.k)
            fleet.v[member].copy_(self.v)
        self.k, self.v = fleet.k[member], fleet.v[member]

    def _ids(self, blocks: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(blocks), dtype=torch.int64,
                            device=self.device)

    def gather(self, blocks: Sequence[int], pad_to: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefix K/V for ``models.lm.prefill_extend``: (k, v), each
        ``(n_layers, 1, len(blocks) * block_size, Hkv, D)``.

        ``pad_to`` pads the block list to a fixed count with block 0, as the
        reference's compile-once admission does; the padded rows are masked
        by ``prefix_len`` in the bucketed ``prefill_extend``."""
        ids = list(blocks)
        if pad_to is not None:
            assert pad_to >= len(ids)
            ids = ids + [0] * (pad_to - len(ids))
        idx = self._ids(ids)

        def view(pool):
            g = pool.index_select(1, idx)            # (L, m, bs, H, D)
            L, m, bs, H, D = g.shape
            return g.reshape(L, 1, m * bs, H, D)

        return view(self.k), view(self.v)

    def scatter(self, blocks: Sequence[int], start_block: int,
                cache: Tuple[torch.Tensor, torch.Tensor]) -> None:
        """Write whole blocks ``start_block..`` of a single-request cache
        ((k, v), each ``(n_layers, 1, Smax, Hkv, D)``) into the pools at
        physical ids ``blocks``: one indexed write per pool."""
        bs = self.block_size
        n = len(blocks)
        idx = self._ids(blocks)
        lo = start_block * bs
        for pool, full in zip((self.k, self.v), cache):
            seg = full[:, 0, lo:lo + n * bs]              # (L, n*bs, H, D)
            L, _, H, D = seg.shape
            pool.index_copy_(1, idx, seg.reshape(L, n, bs, H, D))

    def export_blocks(self, blocks: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copy of the K/V of ``blocks``: (k, v) CPU tensors, each
        ``(n_layers, len(blocks), block_size, Hkv, D)`` — the payload of a
        disaggregated prefill→decode handoff. The copy is taken at once, so
        it survives the pool changing while the payload is in flight."""
        idx = self._ids(blocks)
        return tuple(pool.index_select(1, idx).cpu()
                     for pool in (self.k, self.v))

    def import_blocks(self, blocks: Sequence[int],
                      slabs: Tuple[torch.Tensor, torch.Tensor]) -> None:
        """Write slabs of :meth:`export_blocks` into the pools at physical
        ids ``blocks`` (the decode side of a handoff): one indexed write
        per pool."""
        idx = self._ids(blocks)
        for pool, slab in zip((self.k, self.v), slabs):
            pool.index_copy_(1, idx, slab.to(self.device, pool.dtype))


class FleetKVPools:
    """The K/V pools of a fleet cohort stacked over its members: ``k`` and
    ``v`` are each ``(n_members, n_layers, n_blocks, block_size, Hkv, D)``,
    and member ``m``'s store works on ``k[m]`` and ``v[m]`` (contiguous
    views). Block allocation, refcounts and the radix index stay per engine;
    only the bytes are stacked, so export and import are unchanged at the
    block level."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k, self.v = k, v

    @classmethod
    def stack(cls, stores: Sequence[PagedKVStore]) -> "FleetKVPools":
        """Stack the member stores' pools and re-home each store onto its
        slice (no copy beyond the stack)."""
        self = cls(torch.stack([s.k for s in stores]),
                   torch.stack([s.v for s in stores]))
        for m, s in enumerate(stores):
            s.attach(self, m, copy=False)
        return self
