"""The port's paged KV cache and prefix-reuse engine held against the
reference.

``BlockPool``, ``RadixIndex`` and ``PagedKVCache`` are pure-Python copies:
under the same random operation sequences they must keep the same free
list, refcounts, LRU order, matches and counters. ``PagedKVStore``'s gather,
scatter, export and import must move the same values (exact). With the same
weights and the f32 configs, the port's prefix-cache engine must emit
exactly the reference engine's tokens, QoE records and cache counters, with
and without eviction pressure, through both extend modes (bucketed and
exact-length), and through the disaggregated handoff. No kernel launches on
the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefEngine
from repro.serving import kvcache as rkv
from repro_torch.configs import get
from repro_torch.convert import (kv_store_from_numpy, lm_params_from_numpy,
                                 paged_cache_from)
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.serving import EngineConfig, LLMEngine
from repro_torch.serving import kvcache as kv

NAMES = ("qwen3-1.7b", "stablelm-3b")


@functools.lru_cache(maxsize=None)
def _pair(name: str, dtype: str = "float32"):
    rcfg = dataclasses.replace(ref_get(name).smoke(), dtype=dtype)
    cfg = dataclasses.replace(get(name).smoke(), dtype=dtype)
    params = rlm.init(jax.random.key(0), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return rcfg, params, cfg, model


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = (flash_attention.LAUNCHES, decode_attention.LAUNCHES)
    yield
    assert (flash_attention.LAUNCHES, decode_attention.LAUNCHES) == before


# ---------------------------------------------------------------------------
# the logical cache
# ---------------------------------------------------------------------------
def _pool_state(pool):
    return (list(pool.free), np.asarray(pool.ref).tolist(), list(pool.lru))


def _trie(node):
    """The radix tree as nested (key, block, children) in insertion order."""
    return [(tuple(k), c.block, _trie(c)) for k, c in node.children.items()]


def _cache_state(c):
    return (_pool_state(c.pool), _trie(c.index.root),
            sorted(c.index._by_block), dataclasses.asdict(c.stats))


@pytest.mark.parametrize("seed", range(4))
def test_block_pool_equal_under_random_ops(seed):
    rng = np.random.default_rng(seed)
    mine, ref = kv.BlockPool(12), rkv.BlockPool(12)
    held, cached = [], set()
    for _ in range(300):
        op = int(rng.integers(0, 4))
        if op == 0:
            a, b = mine.take_free(), ref.take_free()
            if a is None:
                a = mine.pop_evictable(lambda blk: blk % 3 != 0)
                b = ref.pop_evictable(lambda blk: blk % 3 != 0)
            assert a == b
            if a is not None:
                held.append(a)
                if rng.random() < 0.5:
                    cached.add(a)
        elif op == 1 and held:
            blk = held.pop(int(rng.integers(0, len(held))))
            mine.release(blk, blk in cached)
            ref.release(blk, blk in cached)
            if blk not in cached:
                cached.discard(blk)
        elif op == 2 and held:
            blk = held[int(rng.integers(0, len(held)))]
            mine.acquire(blk)
            ref.acquire(blk)
            held.append(blk)
        elif op == 3:
            blk = int(rng.integers(0, 12))
            mine.touch(blk)
            ref.touch(blk)
        mine.check_invariants()
        assert _pool_state(mine) == _pool_state(ref)
        assert (mine.n_free, mine.n_evictable) == (ref.n_free, ref.n_evictable)


def _session_like_prompts(rng, n, vocab=5, bs=4):
    """Prompts that share prefixes: extensions of earlier ones and fresh
    ones over a tiny vocabulary (so whole-block chunks collide)."""
    prompts = []
    for _ in range(n):
        if prompts and rng.random() < 0.6:
            base = prompts[int(rng.integers(0, len(prompts)))]
            cut = int(rng.integers(0, len(base) + 1))
            tail = rng.integers(0, vocab, int(rng.integers(1, 3 * bs)))
            prompts.append(np.concatenate([base[:cut], tail]).astype(np.int32))
        else:
            prompts.append(rng.integers(0, vocab, int(rng.integers(1, 6 * bs)))
                           .astype(np.int32))
    return prompts


@pytest.mark.parametrize("seed", range(4))
def test_paged_cache_equal_under_random_admissions(seed):
    """The engine's protocol (match, acquire, allocate, commit, release),
    driven in random order over prefix-sharing prompts with a pool small
    enough to evict: the same matches, blocks, free list, refcounts, LRU
    order, radix tree and counters after every step."""
    rng = np.random.default_rng(seed)
    bs, n_blocks = 4, 10
    mine, ref = kv.PagedKVCache(n_blocks, bs), rkv.PagedKVCache(n_blocks, bs)
    live = []
    for toks in _session_like_prompts(rng, 60, bs=bs):
        m, r = mine.match(toks), ref.match(toks)
        assert m == r
        mine.acquire(m)
        ref.acquire(r)
        cached = mine.index.match(toks)
        assert cached == ref.index.match(toks)
        new = []
        for _ in range(len(cached), len(toks) // bs):
            a, b = mine.allocate(), ref.allocate()
            assert a == b
            if a is None:
                break
            new.append(a)
        if new:
            n_tok = (len(cached) + len(new)) * bs
            mine.commit(toks[:n_tok], cached + new)
            ref.commit(toks[:n_tok], cached + new)
        live.append(m + new)
        while live and (len(live) > 3 or rng.random() < 0.3):
            blocks = live.pop(int(rng.integers(0, len(live))))
            mine.release(blocks)
            ref.release(blocks)
        mine.check_invariants()
        assert _cache_state(mine) == _cache_state(ref)
    assert ref.stats.evictions > 0 and ref.stats.hits > 0


def test_paged_cache_copy_carries_the_logical_state():
    rng = np.random.default_rng(9)
    ref = rkv.PagedKVCache(16, 4)
    for toks in _session_like_prompts(rng, 12):
        blocks = ref.match(toks)
        ref.acquire(blocks)
        cached = ref.index.match(toks)
        new = [b for b in (ref.allocate() for _ in range(
            len(cached), len(toks) // 4)) if b is not None]
        ref.commit(toks[:(len(cached) + len(new)) * 4], cached + new)
        if rng.random() < 0.7:
            ref.release(blocks + new)
    mine = paged_cache_from(ref)
    assert isinstance(mine, kv.PagedKVCache)
    assert _cache_state(mine) == _cache_state(ref)
    mine.check_invariants()
    for toks in _session_like_prompts(np.random.default_rng(10), 20):
        assert mine.match(toks) == ref.match(toks)
    assert mine.stats.as_dict() == ref.stats.as_dict()


# ---------------------------------------------------------------------------
# the physical store
# ---------------------------------------------------------------------------
def _stores(dtype, n_blocks=12, bs=8, seed=0):
    """A reference store with random pools, and the port's converted copy."""
    rcfg, _, cfg, _ = _pair("qwen3-1.7b", dtype)
    ref = rkv.PagedKVStore(rcfg, n_blocks, bs)
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    shp = ref.pools[0][0].shape
    ref._local_pools = [tuple(
        jnp.asarray(rng.standard_normal(shp).astype(np.float32), jdt)
        for _ in range(2))]
    mine = kv_store_from_numpy([tuple(map(np.asarray, p))
                                for p in ref.pools], cfg, "cpu",
                               ref_cache=ref.cache)
    return ref, mine, cfg


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _equal_pools(mine, ref):
    (rk, rv), = ref.pools
    np.testing.assert_array_equal(_np(mine.k), _np(rk))
    np.testing.assert_array_equal(_np(mine.v), _np(rv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_gather_scatter_export_import_equal(dtype):
    ref, mine, cfg = _stores(dtype)
    assert mine.k.shape == (cfg.n_layers, 12, 8, cfg.n_kv_heads, cfg.hd)
    assert mine.k.dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    _equal_pools(mine, ref)
    for blocks, pad in (([3, 1, 7], None), ([5], 4), ([], 2), ([2, 2], 3)):
        got = mine.gather(blocks, pad_to=pad)
        (want,) = ref.gather(blocks, pad_to=pad)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(_np(g), _np(w))
    # scatter whole blocks 1.. of a single-request cache into ids 4, 9
    rng = np.random.default_rng(1)
    shp = (cfg.n_layers, 1, 40, cfg.n_kv_heads, cfg.hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    full = [jnp.asarray(rng.standard_normal(shp).astype(np.float32), jdt)
            for _ in range(2)]
    ref.scatter([4, 9], 1, ((full[0], full[1]),))
    mine.scatter([4, 9], 1, tuple(torch.from_numpy(
        np.array(f, np.float32)).to(mine.k.dtype) for f in full))
    _equal_pools(mine, ref)
    # export, then import into other ids
    got = mine.export_blocks([9, 0, 4])
    (want,) = ref.export_blocks([9, 0, 4])
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(_np(g), _np(w))
    ref.import_blocks([1, 2, 3], [want])
    mine.import_blocks([1, 2, 3], got)
    _equal_pools(mine, ref)


# ---------------------------------------------------------------------------
# the prefix-cache engine against the reference engine
# ---------------------------------------------------------------------------
def _session_prompts(vocab: int, seed: int = 0):
    """A 3-turn session and an agent sharing its system prefix (as
    tests/test_kvcache.py), then a long turn whose suffix bucket overruns
    max_seq, so admission takes the exact-length extend."""
    rng = np.random.default_rng(seed)
    sys_prefix = rng.integers(0, vocab, size=16)
    t1 = np.concatenate([sys_prefix, rng.integers(0, vocab, size=6)])
    t2 = np.concatenate([t1, rng.integers(0, vocab, size=9)])
    t3 = np.concatenate([t2, rng.integers(0, vocab, size=5)])
    other = np.concatenate([sys_prefix, rng.integers(0, vocab, size=7)])
    long = np.concatenate([t3, rng.integers(0, vocab, size=21)])
    return [t1, t2, t3, other, long]


def _results_equal(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i] == want[i], i


def _both_engines(name, **ec):
    rcfg, params, cfg, model = _pair(name)
    ref = RefEngine(rcfg, params, RefEngineConfig(**ec))
    mine = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    return ref, mine, cfg


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [1, 3])
def test_prefix_engine_matches_the_reference_engine(name, chunk):
    """Turns served one after another so reuse can hit: the same tokens,
    QoE records (cached_tokens included) and cache counters, and fewer
    prefill tokens than prompt tokens."""
    ec = dict(max_slots=2, max_seq=64, max_new_tokens=4, prefix_cache=True,
              block_size=8, cache_blocks=24)
    ref, mine, cfg = _both_engines(name, **ec)
    prompts = _session_prompts(cfg.vocab)
    for i, p in enumerate(prompts):
        for eng in (ref, mine):
            eng.submit(i, p, max_new_tokens=4)
            eng.run_to_completion(chunk=chunk)
    _results_equal(mine.results, ref.results)
    assert mine.cache_stats() == ref.cache_stats()
    st = mine.cache_stats()
    assert st["prefill_tokens_total"] == sum(len(p) for p in prompts)
    assert st["prefill_tokens_run"] < st["prefill_tokens_total"]
    assert st["hits"] >= 3
    assert mine.results[4]["cached_tokens"] == 32     # the exact-length path
    assert _cache_state(mine.kv.cache) == _cache_state(ref.kv.cache)
    mine.kv.cache.check_invariants()
    assert not (mine.kv.cache.pool.ref > 0).any()    # no leaked pins


@pytest.mark.parametrize("name", NAMES)
def test_prefix_engine_matches_under_eviction_pressure(name):
    """A pool far smaller than the working set, requests queued together
    and admitted as the slot frees: still the reference's tokens, records
    and counters, evictions included."""
    ec = dict(max_slots=1, max_seq=64, max_new_tokens=3, prefix_cache=True,
              block_size=8, cache_blocks=3)
    ref, mine, cfg = _both_engines(name, **ec)
    prompts = _session_prompts(cfg.vocab, seed=3)
    rng = np.random.default_rng(4)
    fresh = [rng.integers(0, cfg.vocab, n) for n in (17, 25)]
    for eng in (ref, mine):
        for i, p in enumerate(prompts + fresh + prompts[:2]):
            eng.submit(i, p, max_new_tokens=3)
        eng.run_to_completion(chunk=2)
    _results_equal(mine.results, ref.results)
    assert mine.cache_stats() == ref.cache_stats()
    assert mine.cache_stats()["evictions"] > 0
    assert _cache_state(mine.kv.cache) == _cache_state(ref.kv.cache)
    mine.kv.cache.check_invariants()


def test_prefix_engine_tokens_equal_the_uncached_engine():
    """Reuse changes how much is prefilled, not what is served (f32)."""
    _, _, cfg, model = _pair("qwen3-1.7b")
    prompts = _session_prompts(cfg.vocab, seed=5)
    runs = []
    for cache in (False, True):
        eng = LLMEngine(cfg, model, EngineConfig(
            max_slots=2, max_seq=64, max_new_tokens=4, prefix_cache=cache,
            block_size=8, cache_blocks=24), device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(i, p)
            eng.run_to_completion()
        runs.append({i: r["tokens"] for i, r in eng.results.items()})
    assert runs[0] == runs[1]


def test_resubmitting_fully_cached_prompt_allocates_nothing():
    """A prompt whose whole-block path is indexed: the capped match leaves
    one block to prefill, and that chunk's duplicate is not allocated (it
    would evict a live leaf of a full pool)."""
    _, _, cfg, model = _pair("stablelm-3b")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=16)
    eng = LLMEngine(cfg, model, EngineConfig(
        max_slots=1, max_seq=48, max_new_tokens=2, prefix_cache=True,
        block_size=8, cache_blocks=2), device="cpu")
    eng.submit(0, prompt, max_new_tokens=2)
    first = eng.run_to_completion()[0]["tokens"]
    free_before = list(eng.kv.cache.pool.free)
    eng.submit(1, prompt, max_new_tokens=2)
    assert eng.slots[0].block_ids == eng.kv.cache.index.match(prompt)[:1]
    assert list(eng.kv.cache.pool.free) == free_before
    again = eng.run_to_completion()[1]["tokens"]
    assert again == first
    assert eng.cache_stats()["evictions"] == 0
    assert eng.kv.cache.pool.n_evictable == 2
    eng.kv.cache.check_invariants()


def test_cancel_and_retire_release_the_pins():
    _, _, cfg, model = _pair("qwen3-1.7b")
    eng = LLMEngine(cfg, model, EngineConfig(
        max_slots=2, max_seq=64, max_new_tokens=6, prefix_cache=True,
        block_size=8, cache_blocks=16), device="cpu")
    prompts = _session_prompts(cfg.vocab, seed=7)
    eng.submit(0, prompts[0])
    eng.run_to_completion()
    eng.submit(1, prompts[1])
    eng.submit(2, prompts[2])
    assert (eng.kv.cache.pool.ref > 0).any()
    assert eng.slots[0].block_ids and eng.slots[1].block_ids
    assert eng.cancel(1)
    eng.run_to_completion(chunk=4)
    assert not (eng.kv.cache.pool.ref > 0).any()
    eng.kv.cache.check_invariants()


# ---------------------------------------------------------------------------
# disaggregated handoff and flush
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_kv_handoff_gives_the_tokens_of_a_full_prefill(name):
    """``prefill_only`` on one engine, ``export_kv`` → ``import_kv`` into a
    second, decode there: the colocated engine's tokens, the imported
    blocks reused, and the same payload and counters as the reference."""
    rcfg, params, cfg, model = _pair(name)
    ec = dict(max_seq=64, max_new_tokens=5, prefix_cache=True, block_size=8,
              cache_blocks=16)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 19).astype(
        np.int32)
    colo = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    colo.submit(0, prompt, max_new_tokens=5)
    want = colo.run_to_completion()[0]["tokens"]

    src = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    dst = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    rsrc = RefEngine(rcfg, params, RefEngineConfig(**ec))
    blocks = src.prefill_only(7, prompt)
    assert blocks == rsrc.prefill_only(7, prompt)
    assert len(blocks) == len(prompt) // 8
    payload = src.export_kv(blocks)
    for got, ref in zip(payload, rsrc.export_kv(blocks)[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    n_cov = len(blocks) * 8
    assert dst.import_kv(prompt[:n_cov], payload)
    src.release_export(blocks)
    assert not (src.kv.cache.pool.ref > 0).any()
    assert src.cache_stats() == rsrc.cache_stats()
    dst.submit(0, prompt, max_new_tokens=5)
    assert dst.run_to_completion()[0]["tokens"] == want
    st = dst.cache_stats()
    assert st["hits"] == 1 and st["hit_tokens"] == n_cov
    assert dst.results[0]["cached_tokens"] == n_cov
    # a second prefill_only of the same prompt reuses everything
    again = src.prefill_only(8, prompt)
    assert again == blocks and src.cache_stats()["prefill_tokens_run"] == (
        len(prompt) + len(prompt) - n_cov)
    src.release_export(again)
    for eng in (src, dst):
        eng.kv.cache.check_invariants()
    # without a paged store the handoff declines
    plain = LLMEngine(cfg, model, EngineConfig(max_seq=64), device="cpu")
    assert not plain.import_kv(prompt[:n_cov], payload)
    with pytest.raises(ValueError, match="prefix_cache"):
        plain.prefill_only(0, prompt)


def test_import_into_a_full_pool_declines_and_frees():
    _, _, cfg, model = _pair("qwen3-1.7b")
    ec = dict(max_seq=64, prefix_cache=True, block_size=8, cache_blocks=2)
    src = LLMEngine(cfg, model, EngineConfig(**dict(ec, cache_blocks=8)),
                    device="cpu")
    dst = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    prompt = np.arange(24, dtype=np.int32) % cfg.vocab
    blocks = src.prefill_only(0, prompt)
    assert not dst.import_kv(prompt, src.export_kv(blocks))
    assert dst.kv.cache.pool.n_free == 2
    dst.kv.cache.check_invariants()


def test_flush_kv_drops_the_pool_and_active_slots_go_on():
    _, _, cfg, model = _pair("qwen3-1.7b")
    eng = LLMEngine(cfg, model, EngineConfig(
        max_slots=2, max_seq=64, max_new_tokens=5, prefix_cache=True,
        block_size=8, cache_blocks=16), device="cpu")
    prompts = _session_prompts(cfg.vocab, seed=11)
    eng.submit(0, prompts[0])
    eng.run_to_completion()
    eng.submit(1, prompts[1])
    assert eng.slots[0].block_ids
    eng.flush_kv()
    assert eng.slots[0].block_ids == []
    assert eng.kv.cache.index.n_blocks == 0
    assert eng.kv.cache.pool.n_free == 16
    assert not bool(eng.kv.k.any())
    eng.run_to_completion()
    assert len(eng.results[1]["tokens"]) == 5
    eng.kv.cache.check_invariants()
    assert eng.cache_stats()["lookups"] == 0
