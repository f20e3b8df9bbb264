"""Continuous-batching inference engine for one LLM instance: the
counterpart of ``repro.serving.engine``, for every model family of the
config (dense, MoE, the Mamba hybrid, xLSTM, cross-attention vision and the
whisper encoder-decoder).

Orca-style iteration-level scheduling on a fixed slot pool:

* ``submit`` queues a request; admission runs its prefill (padded to a
  bucket length where that is exact) and splices its K/V, recurrent state
  and cross-attention K/V into a free slot of the batched cache;
* ``step`` advances all active slots by one decode token, retiring slots
  that hit their budget or emit EOS and admitting queued requests into the
  freed slots; ``step_n`` runs up to ``n`` iterations on the device with one
  read back;
* per-slot fill lives in ``cache.kv_len``, so ragged occupancy needs no
  re-padding.

It is exact: admission runs the same ``lm.prefill`` the tests hold against
teacher forcing, so a request's tokens equal an offline greedy pass, and
with the same weights the engine's tokens and QoE accounting equal the
reference engine's. Each result carries QoE phase accounting in engine
steps (``ttft_steps``, ``tpot_steps``), as in the reference.

**Prefix reuse** (``EngineConfig.prefix_cache``): admission looks up the
longest cached whole-block prefix of the prompt in a paged KV store
(``serving.kvcache``), gathers it, runs ``lm.prefill_extend`` on only the
uncached suffix (the flash kernel's prefix-extend variant on the card), and
scatters the fresh whole blocks into the pool for later requests; the
gathered prefix lands in the slot's contiguous decode cache, as in the
reference engine. ``prefill_only``, ``export_kv``, ``release_export`` and
``import_kv`` are the two halves of a disaggregated prefill→decode KV
handoff; ``flush_kv`` drops the pool.

The device state (decode cache, next tokens) lives behind a store: the
engine's own tensors, or, once a fleet cohort adopts the engine
(``_attach_fleet``), views of its rows of the cohort's batch
(``serving.fleet``). The control plane never knows the difference.

**Families.** Padding a prompt to its bucket is exact only for
pure-attention patterns without MoE (``lm.bucketable``): a recurrent mixer
integrates padding into its state and MoE capacity lets padding tokens
displace real ones, so other patterns prefill at the prompt's length. The
paged prefix cache takes pure-attention patterns only (MoE FFNs included),
as the reference's does. Audio and vision requests carry their stub
frontend's embeddings in ``submit(extra={"frames": ...})`` /
``{"patches": ...}``, (1, T, d), rounded to bf16 as the reference engine
rounds them; zeros when absent. The engine decodes its contiguous cache,
as the reference engine does: the paged decode kernel reads no engine's
pool.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import Device, resolve
from ..models import lm
from ..models.config import ModelConfig
from .fleet import ChunkWork, FleetMemberStore, decode_chunk_body
from .kvcache import CacheStats, PagedKVStore


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_seq: int = 128
    max_new_tokens: int = 16
    eos_token: int = -1            # -1: never (synthetic vocab)
    prefill_bucket: int = 32       # prompts padded up to a bucket multiple
    # paged prefix reuse
    prefix_cache: bool = False
    block_size: int = 8            # tokens per KV block
    cache_blocks: int = 64         # pool capacity (blocks)


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    submit_step: int = 0       # engine step at submit()
    first_token_step: int = 0  # engine step when prefill emitted token 0
    block_ids: List[int] = dataclasses.field(default_factory=list)
    prompt_tokens: int = 0     # prompt length at admission
    cached_tokens: int = 0     # whole-block prefix reused from the paged pool


class _LocalStore:
    """Engine-local device state (the backing until a cohort adopts the
    engine)."""

    __slots__ = ("cache", "next_token")

    def __init__(self, cache: lm.Cache, next_token: torch.Tensor):
        self.cache = cache
        self.next_token = next_token


class LLMEngine:
    """``model`` is a ``models.lm.LM`` on ``device`` (the card unless the
    caller asks for another device)."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, ecfg: EngineConfig,
                 device: Device = None):
        self.device = resolve(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.ecfg = ecfg
        B = ecfg.max_slots
        self._store = _LocalStore(
            lm.make_cache(cfg, B, ecfg.max_seq, self.device),
            torch.zeros((B, 1), dtype=torch.int32, device=self.device))
        self._fleet = None   # (Cohort, member index) once adopted
        self.slots = [_Slot() for _ in range(B)]
        self.queue: deque = deque()
        self.results: Dict[int, dict] = {}
        self._steps = 0
        self.host_syncs = 0          # device->host reads on the decode path
        self.decode_dispatches = 0   # decode calls (a chunk counts once)
        self.tokens_emitted = 0
        # decode iterations this engine ran itself (a cohort's dispatches
        # count in its own counters)
        self.decode_iterations = 0
        # host seconds in admissions and in decode calls, each ending in
        # its read back from the device
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.admissions = 0
        # padding prompts is exact for pure-attention, non-MoE patterns
        self._bucket_ok = ecfg.prefill_bucket > 0 and lm.bucketable(cfg)
        self.kv: Optional[PagedKVStore] = (
            PagedKVStore(cfg, ecfg.cache_blocks, ecfg.block_size,
                         self.device) if ecfg.prefix_cache else None)

    # -- device-state views (local or fleet-backed) ---------------------------
    @property
    def cache(self) -> lm.Cache:
        return self._store.cache

    @cache.setter
    def cache(self, value: lm.Cache) -> None:
        self._store.cache = value

    @property
    def _next_token(self) -> torch.Tensor:
        return self._store.next_token

    @_next_token.setter
    def _next_token(self, value: torch.Tensor) -> None:
        self._store.next_token = value

    @property
    def fleet_ok(self) -> bool:
        """A cohort may decode past a member's committed iterations,
        touching rows the per-engine path would not: exact only when batch
        rows are independent (no MoE capacity coupling them)."""
        return all(f != "moe" for _, f in self.cfg.pattern)

    def _attach_fleet(self, cohort, member: int) -> None:
        """Adopt this engine into a fleet cohort, which has already
        concatenated its device state (and stacked its pools): from here on
        reads and writes go through a view of its rows."""
        self._fleet = (cohort, member)
        self._store = FleetMemberStore(cohort, member)
        self._sync_fleet_counters()

    def _sync_fleet_counters(self) -> None:
        if self._fleet is None:
            return
        cohort, m = self._fleet
        cohort.counters.active[m] = self.active_count
        cohort.counters.queued[m] = len(self.queue)

    # -- public API -----------------------------------------------------------
    def submit(self, request_id: int, tokens: np.ndarray,
               max_new_tokens: Optional[int] = None,
               extra: Optional[dict] = None) -> None:
        """Queue a request. ``extra`` carries an audio request's "frames"
        or a vision request's "patches", (1, T, d) with T the model's
        cross-attention length (zeros when absent); other keys are
        ignored, as in the reference."""
        self.queue.append((request_id, np.asarray(tokens, np.int32),
                           max_new_tokens or self.ecfg.max_new_tokens,
                           self._cross_input(extra or {}), self._steps))
        self._admit()
        self._sync_fleet_counters()

    def step(self) -> List[int]:
        """One decode iteration for all active slots. Returns retired ids."""
        active = [i for i, s in enumerate(self.slots)
                  if s.request_id is not None]
        if not active:
            self._admit()
            return []
        t0 = time.perf_counter()
        logits, self.cache = lm.decode_step(self.model, self.cfg,
                                            self._next_token, self.cache)
        nxt_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = nxt_dev.cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.host_syncs += 1
        self.decode_dispatches += 1
        self.decode_iterations += 1
        self._next_token = nxt_dev[:, None]
        retired = []
        for i in active:
            s = self.slots[i]
            tok = int(nxt[i])
            s.generated.append(tok)
            s.budget -= 1
            self.tokens_emitted += 1
            if s.budget <= 0 or tok == self.ecfg.eos_token:
                self.results[s.request_id] = self._result(s, self._steps + 1)
                retired.append(s.request_id)
                self._release_slot(i)
        self._steps += 1
        if retired:
            self._admit()
        return retired

    def step_n(self, n: int) -> List[int]:
        """Up to ``n`` decode iterations with ONE read back from the device.

        Bit-identical to ``n`` consecutive ``step()`` calls when no admission
        is pending; with queued work, or ``n <= 1``, it is a single
        ``step()``. The chunk is clipped to the largest active budget.
        Returns all ids retired during the chunk."""
        if n <= 1 or self.queue:
            return self.step()
        active = [i for i, s in enumerate(self.slots)
                  if s.request_id is not None]
        if not active:
            self._admit()
            return []
        budgets = [s.budget if s.request_id is not None else 0
                   for s in self.slots]
        n_eff = min(n, max(budgets[i] for i in active))
        alive = [s.request_id is not None for s in self.slots]
        t0 = time.perf_counter()
        tok, self.cache, outs = decode_chunk_body(
            self.model, self.cfg, self._next_token, self.cache,
            torch.tensor(budgets, dtype=torch.int32, device=self.device),
            torch.tensor(alive, dtype=torch.bool, device=self.device),
            n_eff, self.ecfg.eos_token)
        outs = outs.cpu().numpy()               # (n_eff, 3, B): one read
        self.decode_seconds += time.perf_counter() - t0
        self._next_token = tok
        self.host_syncs += 1
        self.decode_dispatches += 1
        self.decode_iterations += n_eff
        return self._commit_chunk(ChunkWork(outs=outs, n_eff=n_eff,
                                            active=tuple(active)))

    def _commit_chunk(self, work: ChunkWork) -> List[int]:
        """Host half of a decode chunk: tokens, budgets and retirements for
        ``work.n_eff`` iterations, then admission into freed slots."""
        toks, emits, retires = (work.outs[:, 0], work.outs[:, 1],
                                work.outs[:, 2])
        retired: List[int] = []
        for t in range(work.n_eff):
            for i in work.active:
                if not emits[t, i]:
                    continue
                s = self.slots[i]
                s.generated.append(int(toks[t, i]))
                s.budget -= 1
                self.tokens_emitted += 1
                if retires[t, i]:
                    self.results[s.request_id] = self._result(
                        s, self._steps + t + 1)
                    retired.append(s.request_id)
                    # the chunk already released the slot on the device
                    self._release_slot_host(i)
        self._steps += work.n_eff
        if retired:
            self._admit()
        return retired

    def cancel(self, request_id: int) -> bool:
        """Abort a request in a slot or in the queue; no result is kept.
        Frees the slot and admits queued work into it. True if found."""
        for i, s in enumerate(self.slots):
            if s.request_id == request_id:
                self._release_slot(i)
                self._admit()
                self._sync_fleet_counters()
                return True
        for k, item in enumerate(self.queue):
            if item[0] == request_id:
                del self.queue[k]
                self._sync_fleet_counters()
                return True
        return False

    def run_to_completion(self, max_iters: int = 10000,
                          chunk: int = 1) -> Dict[int, dict]:
        """Drain queue and slots. ``chunk > 1`` decodes through
        :meth:`step_n` whenever no admission is pending."""
        it = 0
        while self.queue or any(s.request_id is not None
                                for s in self.slots):
            if chunk > 1:
                self.step_n(chunk)
            else:
                self.step()
            it += 1
            if it > max_iters:
                raise RuntimeError("engine did not drain")
        return self.results

    @property
    def active_count(self) -> int:
        return sum(s.request_id is not None for s in self.slots)

    @property
    def queue_len(self) -> int:
        return self.active_count + len(self.queue)

    def qoe_summary(self) -> dict:
        """Mean phase timings (in engine steps) over completed requests."""
        if not self.results:
            return {"avg_ttft_steps": 0.0, "avg_tpot_steps": 0.0}
        rs = list(self.results.values())
        return {"avg_ttft_steps": float(np.mean([r["ttft_steps"]
                                                 for r in rs])),
                "avg_tpot_steps": float(np.mean([r["tpot_steps"]
                                                 for r in rs]))}

    def cache_stats(self) -> dict:
        """Prefix-cache counters (zeros when paged reuse is off)."""
        st = self.kv.cache.stats if self.kv is not None else CacheStats()
        return st.as_dict()

    # -- disaggregated prefill/decode (KV handoff) ----------------------------
    def prefill_only(self, request_id: int, tokens: np.ndarray) -> List[int]:
        """Prefill half of a disaggregated request: compute (or reuse) the
        whole-block KV of ``tokens`` in the paged store without taking a
        decode slot, and return the block ids pinned for export.

        Pair every call with :meth:`release_export`, or the pins leak. May
        return fewer than ``len(tokens) // block_size`` blocks when the pool
        runs dry; the decode side then prefills the uncovered tail."""
        if self.kv is None:
            raise ValueError("prefill_only needs prefix_cache=True")
        tokens = np.asarray(tokens, np.int32)
        L = len(tokens)
        if L > self.ecfg.max_seq:
            raise ValueError(f"request {request_id}: {L} tokens exceed "
                             f"max_seq {self.ecfg.max_seq}")
        bs = self.kv.block_size
        st = self.kv.cache.stats
        # the uncapped match: no suffix token is needed here, a fully
        # cached prompt exports with no compute
        cached = self.kv.cache.index.match(tokens)
        self.kv.cache.acquire(cached)
        prefix_len = len(cached) * bs
        st.lookups += 1
        if cached:
            st.hits += 1
            st.hit_tokens += prefix_len
        st.prefill_tokens_total += L
        st.prefill_tokens_run += L - prefix_len
        new_ids: List[int] = []
        if L // bs > len(cached):
            suffix = self._tokens(tokens[prefix_len:])
            if cached:
                _, one = lm.prefill_extend(
                    self.model, self.cfg, suffix, self.kv.gather(cached),
                    max_seq=self.ecfg.max_seq)
            else:
                _, one = lm.prefill(self.model, self.cfg, suffix,
                                    max_seq=self.ecfg.max_seq)
            new_ids = self._cache_fresh_blocks(tokens, cached, one)
        return cached + new_ids

    def export_kv(self, block_ids: List[int]):
        """Host copy of the pinned blocks of a :meth:`prefill_only` result
        (the payload of the KV handoff)."""
        if self.kv is None:
            raise ValueError("export_kv needs prefix_cache=True")
        return self.kv.export_blocks(block_ids)

    def release_export(self, block_ids: List[int]) -> None:
        """Drop the export pins: committed blocks become evictable, the
        uncommitted return to the free list."""
        if self.kv is not None and block_ids:
            self.kv.cache.release(block_ids)

    def import_kv(self, tokens: np.ndarray, slabs) -> bool:
        """Decode half of the handoff: land exported slabs covering the
        whole-block prefix ``tokens`` in this engine's pool and index them,
        so the next ``submit`` of the full prompt reuses them. False (the
        caller re-prefills) without a paged store or when the pool cannot
        supply the blocks."""
        if self.kv is None:
            return False
        tokens = np.asarray(tokens, np.int32)
        n = len(tokens) // self.kv.block_size
        if n * self.kv.block_size != len(tokens):
            raise ValueError("KV import must be whole-block")
        if n == 0:
            return False
        ids: List[int] = []
        for _ in range(n):
            bid = self.kv.cache.allocate()
            if bid is None:
                self.kv.cache.release(ids)   # uncommitted -> free list
                return False
            ids.append(bid)
        self.kv.import_blocks(ids, slabs)
        # commit keeps the canonical blocks of chunks already indexed; our
        # duplicates stay unindexed and free on release
        self.kv.cache.commit(tokens, ids)
        self.kv.cache.release(ids)
        return True

    def flush_kv(self) -> None:
        """Simulated node restart: drop every cached KV block. Active slots
        keep decoding from their contiguous caches; their block pins go
        with the pool. An adopted engine's fresh store is re-homed onto its
        slice of the cohort's pools, which the copy of the fresh zeros
        wipes."""
        if self.kv is None:
            return
        for s in self.slots:
            s.block_ids = []
        self.kv = PagedKVStore(self.cfg, self.ecfg.cache_blocks,
                               self.ecfg.block_size, self.device)
        if self._fleet is not None:
            cohort, m = self._fleet
            if cohort.kv_pools is not None:
                self.kv.attach(cohort.kv_pools, m)

    # -- internals -------------------------------------------------------------
    def _release_slot_host(self, i: int) -> None:
        """Drop slot ``i``'s KV-block pins and reset its record (a decode
        chunk has already released it on the device)."""
        s = self.slots[i]
        if self.kv is not None and s.block_ids:
            self.kv.cache.release(s.block_ids)
        self.slots[i] = _Slot()
        self._sync_fleet_counters()

    def _release_slot(self, i: int) -> None:
        """Retire or cancel slot ``i``: drop its pins, zero its ``kv_len``
        so decode stops attending over the dead slot's cache, and reset its
        next token."""
        self._release_slot_host(i)
        self.cache.kv_len[i] = 0
        self._next_token[i, 0] = 0

    def _result(self, s: _Slot, finish_step: int) -> dict:
        n_decode = max(len(s.generated) - 1, 0)  # token 0 comes from prefill
        return {
            "tokens": list(s.generated),
            "n_steps": len(s.generated),
            "submit_step": s.submit_step,
            "first_token_step": s.first_token_step,
            "finish_step": finish_step,
            "ttft_steps": s.first_token_step - s.submit_step,
            "tpot_steps": ((finish_step - s.first_token_step) / n_decode
                           if n_decode else 0.0),
            "decode_steps": finish_step - s.first_token_step,
            # realized prefix-cache reuse of this request's admission
            "prompt_tokens": s.prompt_tokens,
            "cached_tokens": s.cached_tokens,
            "cached_frac": (s.cached_tokens / s.prompt_tokens
                            if s.prompt_tokens else 0.0),
        }

    def _admit(self) -> None:
        while self.queue:
            free = [i for i, s in enumerate(self.slots)
                    if s.request_id is None]
            if not free:
                break
            request_id, tokens, budget, cross, submit_step = \
                self.queue.popleft()
            self._prefill_into(free[0], request_id, tokens, budget, cross,
                               submit_step)
        self._sync_fleet_counters()

    def _bucket_len(self, n: int) -> int:
        """Smallest prefill-bucket multiple >= n, capped at max_seq."""
        b = self.ecfg.prefill_bucket
        return min(-(-n // b) * b, self.ecfg.max_seq)

    def _cross_input(self, extra: dict) -> dict:
        """The ``lm.prefill`` keyword of an audio / vision request: its
        frames or patches on the engine's device in bf16, zeros when
        absent. Empty for the other families."""
        cfg = self.cfg
        if cfg.family not in ("audio", "vlm"):
            return {}
        name = "frames" if cfg.family == "audio" else "patches"
        shape = (1, cfg.cross_kv_tokens, cfg.d_model)
        x = extra.get(name)
        x = (torch.zeros(shape, device=self.device) if x is None
             else torch.as_tensor(x))
        if tuple(x.shape) != shape:
            raise ValueError(f"{cfg.name}: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        return {name: x.to(device=self.device, dtype=torch.bfloat16)}

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(toks, np.int32)).to(
            self.device, torch.int64)[None]

    def _padded(self, toks: np.ndarray) -> np.ndarray:
        """``toks`` zero-padded to its bucket length."""
        out = np.zeros(self._bucket_len(len(toks)), np.int32)
        out[:len(toks)] = toks
        return out

    def _cache_fresh_blocks(self, tokens: np.ndarray, cached: List[int],
                            one: lm.Cache) -> List[int]:
        """Allocate, fill from the single-request cache ``one`` and index
        the whole blocks of ``tokens`` past the ``cached`` ones; stops where
        the pool runs dry (the rest is served uncached)."""
        bs = self.kv.block_size
        new_ids: List[int] = []
        for _ in range(len(cached), len(tokens) // bs):
            bid = self.kv.cache.allocate()
            if bid is None:
                break
            new_ids.append(bid)
        if new_ids:
            self.kv.scatter(new_ids, len(cached), (one.k, one.v))
            n_tok = (len(cached) + len(new_ids)) * bs
            self.kv.cache.commit(tokens[:n_tok], cached + new_ids)
        return new_ids

    def _prefill_into(self, slot: int, request_id: int, tokens: np.ndarray,
                      budget: int, cross: dict, submit_step: int = 0
                      ) -> None:
        e = self.ecfg
        L = len(tokens)
        if L + budget > e.max_seq:
            raise ValueError(f"request {request_id}: {L} prompt + {budget} "
                             f"new tokens exceed max_seq {e.max_seq}")
        t0 = time.perf_counter()
        matched: List[int] = []
        if self.kv is not None:
            matched = self.kv.cache.match(tokens)
            self.kv.cache.acquire(matched)
        prefix_len = len(matched) * e.block_size
        if prefix_len:
            suffix = tokens[prefix_len:]
            Sn = len(suffix)
            Sn_pad = self._bucket_len(Sn) if self._bucket_ok else Sn
            if self._bucket_ok and prefix_len + Sn_pad <= e.max_seq:
                # the reference's compile-once admission: the suffix padded
                # to its bucket, the prefix gathered at the full block
                # budget (padded with block 0, masked by prefix_len)
                logits, one = lm.prefill_extend(
                    self.model, self.cfg, self._tokens(self._padded(suffix)),
                    self.kv.gather(matched, pad_to=e.max_seq // e.block_size),
                    max_seq=e.max_seq, prefix_len=prefix_len, length=Sn)
            else:
                logits, one = lm.prefill_extend(
                    self.model, self.cfg, self._tokens(suffix),
                    self.kv.gather(matched), max_seq=e.max_seq)
        else:
            # pad the prompt to the bucket where that is exact; logits are
            # read at the true last row and kv_len masks the tail
            toks = self._padded(tokens) if self._bucket_ok else tokens
            logits, one = lm.prefill(self.model, self.cfg,
                                     self._tokens(toks), max_seq=e.max_seq,
                                     length=L, **cross)
        block_ids = matched
        if self.kv is not None:
            st = self.kv.cache.stats
            st.prefill_tokens_total += L
            st.prefill_tokens_run += L - prefix_len
            # cache the fresh whole blocks, starting past every chunk the
            # index already holds, not just the capped match: a fully cached
            # prompt's last block (capped off to leave a suffix) is not
            # allocated again only to be dropped by commit()
            block_ids = matched + self._cache_fresh_blocks(
                tokens, self.kv.cache.index.match(tokens), one)
        # splice the single-request cache into the batch cache at `slot`:
        # K/V, recurrent state and cross K/V, every leaf batched on dim 1
        self.cache.k[:, slot] = one.k[:, 0]
        self.cache.v[:, slot] = one.v[:, 0]
        for key, leaf in self.cache.state.items():
            leaf[:, slot] = one.state[key][:, 0]
        self.cache.kv_len[slot] = L
        first = int(torch.argmax(logits[0]))
        self.prefill_seconds += time.perf_counter() - t0
        self.admissions += 1
        s = self.slots[slot]
        s.request_id = request_id
        s.generated = [first]
        s.budget = budget - 1
        s.submit_step = submit_step
        s.first_token_step = self._steps
        s.block_ids = block_ids
        s.prompt_tokens = L
        s.cached_tokens = prefix_len
        self._next_token[slot, 0] = first
        if s.budget <= 0:
            self.results[request_id] = self._result(s, self._steps)
            self._release_slot(slot)
