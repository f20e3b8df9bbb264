"""Deterministic sharded token pipeline: a copy of ``repro.data.pipeline``
(numpy and a prefetch thread, nothing of JAX), so the port imports nothing
of the JAX package; ``tests/test_torch_data.py`` holds its batches bit-equal
to the original's.

Production properties reproduced here:

* **deterministic per-host sharding** — batch row r of global step t is a
  pure function of (seed, t, r); each host materializes only its addressable
  rows, so the pipeline is identical on 1 host or 1000 and a restart at step
  t resumes mid-epoch with no state file;
* **background prefetch** — a one-slot prefetch thread overlaps host batch
  synthesis with device execution;
* **learnable structure** — the synthetic corpus is a mixture of k-order
  Markov chains over the vocab (per-document transition keys), so
  cross-entropy genuinely decreases during the example training runs —
  a pure-uniform stream would pin the loss at log V and hide optimizer bugs.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_chains: int = 8          # Markov mixture components
    branch: int = 32           # successors per state


class SyntheticLMData:
    def __init__(self, cfg: DataConfig, host_index: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        root = np.random.default_rng(np.random.SeedSequence([cfg.seed, 99]))
        # per-chain successor tables: state -> branch successors
        self._succ = root.integers(
            0, cfg.vocab, size=(cfg.n_chains, cfg.vocab, cfg.branch),
            dtype=np.int32)

    # -- pure row synthesis ---------------------------------------------------
    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row]))
        chain = int(rng.integers(0, cfg.n_chains))
        succ = self._succ[chain]
        out = np.empty(cfg.seq_len + 1, np.int32)
        tok = int(rng.integers(0, cfg.vocab))
        picks = rng.integers(0, cfg.branch, size=cfg.seq_len + 1)
        for i in range(cfg.seq_len + 1):
            out[i] = tok
            tok = int(succ[tok, picks[i]])
        return out

    def batch(self, step: int) -> dict:
        rows = [self._row(step, self.host_index * self.local_batch + r)
                for r in range(self.local_batch)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    # -- prefetching iterator ---------------------------------------------------
    def iterator(self, start_step: int = 0, prefetch: int = 2
                 ) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch(step)))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                _, b = q.get()
                yield b
        finally:
            stop.set()
