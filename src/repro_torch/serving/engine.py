"""Continuous-batching inference engine for one LLM instance: the
counterpart of ``repro.serving.engine`` for a dense model and a contiguous
KV cache.

Orca-style iteration-level scheduling on a fixed slot pool:

* ``submit`` queues a request; admission runs its prefill (padded to a
  bucket length) and splices the K/V into a free slot of the batched cache;
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

Not ported yet (they raise ``NotImplementedError``): the paged prefix cache
(``prefix_cache=True``), disaggregated prefill (``prefill_only``,
``export_kv``, ``import_kv``), ``flush_kv`` and fleet adoption — ROADMAP
Queue 1 item 11.
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
from .fleet import ChunkWork, decode_chunk_body

_LATER = "not ported yet (ROADMAP Queue 1 item 11)"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_seq: int = 128
    max_new_tokens: int = 16
    eos_token: int = -1            # -1: never (synthetic vocab)
    prefill_bucket: int = 32       # prompts padded up to a bucket multiple
    # paged prefix reuse: not ported yet (must stay False)
    prefix_cache: bool = False


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    submit_step: int = 0       # engine step at submit()
    first_token_step: int = 0  # engine step when prefill emitted token 0
    prompt_tokens: int = 0     # prompt length at admission


class LLMEngine:
    """``model`` is a ``models.lm.LM`` on ``device`` (the card unless the
    caller asks for another device)."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, ecfg: EngineConfig,
                 device: Device = None):
        if ecfg.prefix_cache:
            raise NotImplementedError(f"prefix_cache=True is {_LATER}")
        lm.check_dense(cfg)
        self.device = resolve(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.ecfg = ecfg
        B = ecfg.max_slots
        self.cache = lm.make_cache(cfg, B, ecfg.max_seq, self.device)
        self._next_token = torch.zeros((B, 1), dtype=torch.int32,
                                       device=self.device)
        self.slots = [_Slot() for _ in range(B)]
        self.queue: deque = deque()
        self.results: Dict[int, dict] = {}
        self._steps = 0
        self.host_syncs = 0          # device->host reads on the decode path
        self.decode_dispatches = 0   # decode calls (a chunk counts once)
        self.tokens_emitted = 0
        # host seconds in admissions and in decode calls, each ending in
        # its read back from the device
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.admissions = 0
        # padding prompts is exact for the dense pattern (rows independent)
        self._bucket_ok = ecfg.prefill_bucket > 0

    # -- public API -----------------------------------------------------------
    def submit(self, request_id: int, tokens: np.ndarray,
               max_new_tokens: Optional[int] = None) -> None:
        self.queue.append((request_id, np.asarray(tokens, np.int32),
                           max_new_tokens or self.ecfg.max_new_tokens,
                           self._steps))
        self._admit()

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
                    self.slots[i] = _Slot()
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
                return True
        for k, item in enumerate(self.queue):
            if item[0] == request_id:
                del self.queue[k]
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

    # -- later slices ---------------------------------------------------------
    def prefill_only(self, request_id, tokens):
        raise NotImplementedError(f"prefill_only is {_LATER}")

    def export_kv(self, block_ids):
        raise NotImplementedError(f"export_kv is {_LATER}")

    def import_kv(self, tokens, slabs):
        raise NotImplementedError(f"import_kv is {_LATER}")

    def flush_kv(self):
        raise NotImplementedError(f"flush_kv is {_LATER}")

    def _attach_fleet(self, cohort, member):
        raise NotImplementedError(f"fleet adoption is {_LATER}")

    # -- internals -------------------------------------------------------------
    def _release_slot(self, i: int) -> None:
        """Retire or cancel slot ``i``: zero its ``kv_len`` so decode stops
        attending over the dead slot's cache, and reset its next token."""
        self.slots[i] = _Slot()
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
            # no prefix reuse in this engine yet
            "prompt_tokens": s.prompt_tokens,
            "cached_tokens": 0,
            "cached_frac": 0.0,
        }

    def _admit(self) -> None:
        while self.queue:
            free = [i for i, s in enumerate(self.slots)
                    if s.request_id is None]
            if not free:
                break
            request_id, tokens, budget, submit_step = self.queue.popleft()
            self._prefill_into(free[0], request_id, tokens, budget,
                               submit_step)

    def _bucket_len(self, n: int) -> int:
        """Smallest prefill-bucket multiple >= n, capped at max_seq."""
        b = self.ecfg.prefill_bucket
        return min(-(-n // b) * b, self.ecfg.max_seq)

    def _prefill_into(self, slot: int, request_id: int, tokens: np.ndarray,
                      budget: int, submit_step: int = 0) -> None:
        e = self.ecfg
        L = len(tokens)
        if L + budget > e.max_seq:
            raise ValueError(f"request {request_id}: {L} prompt + {budget} "
                             f"new tokens exceed max_seq {e.max_seq}")
        t0 = time.perf_counter()
        # pad the prompt to the bucket; logits are read at the true last row
        # and kv_len masks the tail
        L_pad = self._bucket_len(L) if self._bucket_ok else L
        toks = np.zeros(L_pad, np.int32)
        toks[:L] = tokens
        logits, one = lm.prefill(
            self.model, self.cfg,
            torch.from_numpy(toks).to(self.device, torch.int64)[None],
            max_seq=e.max_seq, length=L)
        # splice the single-request cache into the batch cache at `slot`
        self.cache.k[:, slot] = one.k[:, 0]
        self.cache.v[:, slot] = one.v[:, 0]
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
        s.prompt_tokens = L
        self._next_token[slot, 0] = first
        if s.budget <= 0:
            self.results[request_id] = self._result(s, self._steps)
            self._release_slot(slot)
