"""Fleet data plane: a cohort of engines decodes as one batch, the
counterpart of ``repro.serving.fleet``.

A **cohort** is a set of engines sharing one ``(ModelConfig, EngineConfig,
model)`` identity (``build_cohorts`` keys by the model object's identity).
The reference stacks the members' device state on a leading member axis and
``vmap``s the decode chunk over it. Here the member axis is flattened into
the batch: the cohort keeps ONE ``lm.Cache`` whose every leaf has the
member axis flattened into its batch dim (``k`` and ``v`` ``(n_attn,
members × max_slots, Smax, Hkv, D)``, likewise each recurrent-state and
cross-K/V leaf of ``state``) and one next-token tensor ``(members ×
max_slots, 1)``; member ``m`` owns rows ``[m·B, (m+1)·B)``.
A cohort decode iteration is then one ``lm.decode_step`` over all rows: one
GEMM per projection and one decode-kernel launch per layer for the whole
cohort, not one per member.

Split of responsibilities:

* **device data plane (here)** — ``FleetState``, ``decode_chunk_body`` (the
  loop shared with ``LLMEngine.step_n``) and ``Cohort.dispatch``;
* **host control plane (``engine.LLMEngine``)** — admission, continuous
  batching, prefix matching and result accounting, unchanged. An adopted
  engine reads and writes its device state through ``FleetMemberStore``:
  views of its rows of the cohort's tensors, so every slot write lands in
  the cohort's storage in place. (The reference's member store is
  write-back, a gathered copy flushed before each dispatch, because JAX
  arrays cannot be written in place; a view needs neither the flush nor
  the dispatch epochs.)

**Participation.** A dispatch advances only its participating members (the
eligible ones with live slots and, for ``n > 1``, an empty admission queue,
as ``step_n`` requires). All rows are decoded; non-participants' rows are
dead in the chunk (no budget, not alive), and after it their ``kv_len`` and
next tokens are put back. So a skipped member's ``kv_len``, next tokens and
cache rows below its fill are unchanged by a dispatch: the chunk writes K/V
only at a row's ``kv_len`` and beyond, which a later decode overwrites before
it reads and an admission rewrites whole. A recurrent state is overwritten
by every decode, so the live rows of skipped members have their state
copied aside before the chunk and put back after it. The reference instead gathers the
participants' rows (padded to a power of two for its jit cache) and
scatters them back; in torch that gather would copy every participant's
cache each dispatch, and nothing recompiles for a new batch size.

Exactness: a dispatch runs ``n_f = max`` over the participants' clipped
chunk lengths, but each member commits only its own ``n_eff`` iterations;
past its ``n_eff`` a member's rows are all dead, and every op is row
independent for the patterns ``LLMEngine.fleet_ok`` admits (no MoE
capacity couples the rows), so fleet stepping gives per-engine
``step()`` / ``step_n()`` results exactly (up to the rounding a batch size
may change in a matrix product).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig
from .kvcache import FleetKVPools


class FleetState(NamedTuple):
    """A cohort's device state, the member axis flattened into the batch."""

    # every leaf batched on dim 1 over M*B rows; kv_len (M*B,)
    cache: lm.Cache
    next_token: torch.Tensor   # (M*B, 1) int32


def decode_chunk_body(model: lm.LM, cfg: ModelConfig, tok: torch.Tensor,
                      cache: lm.Cache, budget: torch.Tensor,
                      alive: torch.Tensor, n: int, eos: int):
    """``n`` decode iterations with retirement on the device.

    The reference's ``lax.scan`` becomes a loop, step for step the same:
    every iteration decodes all slots, budgets drop for live slots, a live
    slot retires on an exhausted budget or EOS (its ``kv_len`` zeroes and
    its next token resets, as ``LLMEngine._release_slot`` does), and dead
    slots go on decoding what nothing reads. Nothing is read back inside
    the loop. Returns (next tokens (B, 1), cache, outs) with ``outs`` one
    stacked (n, 3, B) int32 tensor of (token, emitted, retired)."""
    outs = []
    for _ in range(n):
        logits, cache = lm.decode_step(model, cfg, tok, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emit = alive
        budget = budget - alive.to(torch.int32)
        retire = alive & ((budget <= 0) | (nxt == eos))
        alive = alive & ~retire
        cache = cache._replace(kv_len=torch.where(
            retire, torch.zeros_like(cache.kv_len), cache.kv_len))
        tok = torch.where(retire, torch.zeros_like(nxt), nxt)[:, None]
        outs.append(torch.stack([nxt, emit.to(torch.int32),
                                 retire.to(torch.int32)]))
    return tok, cache, torch.stack(outs)


class FleetMemberStore:
    """One engine's view of its rows of a cohort's ``FleetState``.

    ``cache`` and ``next_token`` are views into the cohort's tensors, so the
    engine's in-place slot writes land there. Assigning a new value (the
    engine rebinds its cache after a decode, whose ``kv_len`` is a new
    tensor) copies it into the rows; the cohort's tensors are never
    rebound."""

    def __init__(self, cohort: "Cohort", member: int):
        B = cohort.ecfg.max_slots
        rows = slice(member * B, (member + 1) * B)
        c = cohort.state.cache
        self._cache = lm.Cache(
            k=c.k[:, rows], v=c.v[:, rows], kv_len=c.kv_len[rows],
            state={key: leaf[:, rows] for key, leaf in c.state.items()})
        self._next = cohort.state.next_token[rows]

    @property
    def cache(self) -> lm.Cache:
        return self._cache

    @cache.setter
    def cache(self, value: lm.Cache) -> None:
        mine, new = self._cache, value
        pairs = [(mine.k, new.k), (mine.v, new.v), (mine.kv_len, new.kv_len)]
        pairs += [(mine.state[key], new.state[key]) for key in mine.state]
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)

    @property
    def next_token(self) -> torch.Tensor:
        return self._next

    @next_token.setter
    def next_token(self, value: torch.Tensor) -> None:
        if value is not self._next:
            self._next.copy_(value)


class ChunkWork(NamedTuple):
    """One engine's share of a decode chunk, ready for the host commit."""

    outs: np.ndarray       # (n, 3, B) host array (token, emitted, retired)
    n_eff: int             # iterations to commit
    active: Sequence[int]  # slots active at dispatch time


class CohortCounters:
    """Per-member fleet counters (numpy, host side).

    ``active``/``queued`` mirror each member's slot and queue occupancy
    (the engine syncs them on every mutation), so the server aggregates
    load without a loop over engines; ``emitted``/``retired`` accumulate
    from the chunk outputs, one sum per dispatch. ``iterations`` counts the
    decode iterations the dispatches ran (each one ``lm.decode_step`` over
    all the cohort's rows) and ``decode_seconds`` their host seconds, each
    dispatch ending in its read back."""

    def __init__(self, n_members: int):
        self.active = np.zeros(n_members, np.int64)
        self.queued = np.zeros(n_members, np.int64)
        self.emitted = np.zeros(n_members, np.int64)
        self.retired = np.zeros(n_members, np.int64)
        self.dispatches = 0
        self.iterations = 0
        self.decode_seconds = 0.0


class CohortDispatch(NamedTuple):
    """Result of one cohort decode dispatch."""

    work: Dict[int, ChunkWork]   # member -> commit work (empty: no dispatch)
    emitted: np.ndarray          # (M,) tokens emitted this chunk, per member
    retired: np.ndarray          # (M,) slots retired this chunk, per member

    @property
    def participants(self) -> int:
        """Members that rode this dispatch (0: no dispatch ran)."""
        return len(self.work)


class Cohort:
    """Engines sharing one (ModelConfig, EngineConfig, model) identity whose
    device state is one flattened batch.

    Adoption concatenates the members' caches and next tokens into the
    cohort's tensors and, with paged prefix reuse, stacks their K/V pools
    (``FleetKVPools``); the engines then work on views
    (``FleetMemberStore``). ``dispatch`` advances every participating member
    in one decode chunk over all rows."""

    def __init__(self, engines: Sequence):
        if not engines:
            raise ValueError("a cohort needs at least one engine")
        e0 = engines[0]
        self.cfg, self.ecfg, self.model = e0.cfg, e0.ecfg, e0.model
        self.device = e0.device
        for e in engines[1:]:
            if e.cfg != self.cfg or e.ecfg != self.ecfg:
                raise ValueError("cohort members must share (ModelConfig, "
                                 "EngineConfig)")
            if e.model is not self.model:
                raise ValueError("cohort members must share one model")
        for e in engines:
            if not e.fleet_ok:
                raise ValueError(f"{e.cfg.name}: the pattern cannot decode "
                                 f"as one batch")
        self.members = list(engines)
        M = len(self.members)
        caches = [e.cache for e in self.members]
        self.state = FleetState(
            cache=lm.Cache(
                k=torch.cat([c.k for c in caches], dim=1),
                v=torch.cat([c.v for c in caches], dim=1),
                kv_len=torch.cat([c.kv_len for c in caches]),
                state={key: torch.cat([c.state[key] for c in caches], dim=1)
                       for key in caches[0].state}),
            next_token=torch.cat([e._next_token for e in self.members]))
        del caches
        self.kv_pools = None
        if self.ecfg.prefix_cache and all(e.kv is not None
                                          for e in self.members):
            self.kv_pools = FleetKVPools.stack([e.kv for e in self.members])
        self.counters = CohortCounters(M)
        for m, eng in enumerate(self.members):
            eng._attach_fleet(self, m)

    def __len__(self) -> int:
        return len(self.members)

    def dispatch(self, n: int, eligible: Sequence[int]) -> CohortDispatch:
        """One decode chunk for every participating member.

        ``eligible`` pre-filters members (the server drops crashed nodes and
        stragglers without credit); a member takes part when it has live
        slots and, for ``n > 1``, an empty admission queue (``step_n``'s
        fall-back), so chunking never skips an admission a per-engine
        ``step()`` would run. Returns each participant's ``ChunkWork`` for
        the host commit and the per-member emitted / retired counts, from
        the one read back of the whole cohort."""
        n = max(int(n), 1)
        work_slots: Dict[int, List[int]] = {}
        for m in eligible:
            eng = self.members[m]
            if n > 1 and eng.queue:
                continue   # step_n would fall back: keep per-engine semantics
            active = [i for i, s in enumerate(eng.slots)
                      if s.request_id is not None]
            if active:
                work_slots[m] = active
        M = len(self.members)
        zero = np.zeros(M, np.int64)
        if not work_slots:
            return CohortDispatch({}, zero, zero)
        B = self.ecfg.max_slots
        parts = sorted(work_slots)
        budgets = np.zeros((M, B), np.int32)
        alive = np.zeros((M, B), bool)
        n_eff: Dict[int, int] = {}
        for m in parts:
            for i in work_slots[m]:
                budgets[m, i] = self.members[m].slots[i].budget
                alive[m, i] = True
            n_eff[m] = min(n, int(budgets[m, alive[m]].max()))
        n_f = max(n_eff.values())
        part_rows = np.zeros((M, B), bool)
        part_rows[parts] = True
        dev = self.device
        st = self.state
        t0 = time.perf_counter()
        # the recurrent state of skipped members' live rows, put back below
        kept = [m * B + i for m in range(M) if m not in n_eff
                for i, s in enumerate(self.members[m].slots)
                if s.request_id is not None]
        saved = {}
        if kept:
            idx = torch.tensor(kept, dtype=torch.int64, device=dev)
            saved = {key: leaf.index_select(1, idx)
                     for key, leaf in st.cache.state.items()
                     if not key.startswith("cross.")}
        tok, cache, outs = decode_chunk_body(
            self.model, self.cfg, st.next_token, st.cache,
            torch.from_numpy(budgets.reshape(-1)).to(dev),
            torch.from_numpy(alive.reshape(-1)).to(dev), n_f,
            self.ecfg.eos_token)
        for key, leaf in saved.items():
            st.cache.state[key].index_copy_(1, idx, leaf)
        # K/V and state were written in place; lengths and next tokens
        # advance for the participants' rows only
        rows = torch.from_numpy(part_rows.reshape(-1)).to(dev)
        st.cache.kv_len.copy_(torch.where(rows, cache.kv_len,
                                          st.cache.kv_len))
        st.next_token.copy_(torch.where(rows[:, None], tok, st.next_token))
        outs_np = outs.cpu().numpy()      # ONE read back for the whole cohort
        c = self.counters
        c.decode_seconds += time.perf_counter() - t0
        c.dispatches += 1
        c.iterations += n_f
        # (n_f, 3, M*B) -> (M, n_f, 3, B); a non-participant's rows are all
        # dead (emit == retire == 0), so the sums over every member are exact
        per = outs_np.reshape(n_f, 3, M, B).transpose(2, 0, 1, 3)
        emitted = per[:, :, 1, :].sum(axis=(1, 2)).astype(np.int64)
        retired = per[:, :, 2, :].sum(axis=(1, 2)).astype(np.int64)
        c.emitted += emitted
        c.retired += retired
        work = {m: ChunkWork(outs=per[m], n_eff=n_eff[m],
                             active=tuple(work_slots[m])) for m in parts}
        return CohortDispatch(work, emitted, retired)


def build_cohorts(engines: Dict[int, object]):
    """Group engines into cohorts by shared (ModelConfig, EngineConfig,
    model identity); engines that cannot decode as one batch stay loose.

    Returns ``(cohorts, cohort_pairs, pair_to_cohort)``: ``cohort_pairs[c]``
    lists the pair ids of cohort ``c`` in pair order and ``pair_to_cohort``
    maps a pair id to (cohort index, member index)."""
    groups: Dict[tuple, List[int]] = {}
    for pair in sorted(engines):
        eng = engines[pair]
        if not eng.fleet_ok:
            continue
        key = (eng.cfg, eng.ecfg, id(eng.model))
        groups.setdefault(key, []).append(pair)
    cohorts: List[Cohort] = []
    cohort_pairs: List[List[int]] = []
    pair_to_cohort: Dict[int, tuple] = {}
    for pairs in groups.values():
        c = len(cohorts)
        cohorts.append(Cohort([engines[p] for p in pairs]))
        cohort_pairs.append(pairs)
        for m, p in enumerate(pairs):
            pair_to_cohort[p] = (c, m)
    return cohorts, cohort_pairs, pair_to_cohort
