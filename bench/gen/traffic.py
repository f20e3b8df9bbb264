"""The one traffic generator: a traffic file's parameters -> the requests
of a run and the instants they are due.

A traffic file (``bench/traffic/<name>.json``) names a request ``mix``
and an ``arrivals`` process with their parameters. The seed changes the
order of the work and not its size: every seed draws on one fixed pool of
requests (``pool`` requests of the mix, built from ``pool_seed``) and one
fixed Poisson draw of ``pool`` arrival instants at ``rate_rps`` (from
``pool_seed``), and only permutes the requests over those instants,
keeping the mix's round-robin order of datasets (within each dataset the
seed shuffles the pool). So every seed sends as many requests inside a
window, at the same instants, with the same prompts and budgets in
another order, and a run's work does not swing with its seed.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

from . import paper_mix

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"
MIXES = {"paper-mix": paper_mix}
ARRIVALS = ("poisson",)


@dataclasses.dataclass(frozen=True)
class Arrival:
    index: int                  # request id, in due order
    due_s: float                # seconds after the window opens
    req: paper_mix.Request
    max_new_tokens: int


def load(name: str) -> dict:
    """The traffic file of ``name``."""
    spec = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    if spec["mix"] not in MIXES or spec["arrivals"] not in ARRIVALS:
        raise ValueError(f"traffic {name}: unknown mix or arrivals in {spec}")
    return spec


def budget(resp_tokens_mean: float, cap: int) -> int:
    """A request's max_new_tokens: its task's mean response length."""
    return int(np.clip(round(float(resp_tokens_mean)), 1, cap))


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def schedule(spec: dict, seed: int) -> List[Arrival]:
    """Every request of the run in due order: ``spec['pool']`` of them,
    due from 0 on; the caller submits those due inside its window."""
    mix = MIXES[spec["mix"]]
    n, pool_seed = int(spec["pool"]), int(spec["pool_seed"])
    reqs = mix.round_robin(n, seed=pool_seed)
    order = mix.ORDER
    # the seed's permutation of each dataset's requests, round robin kept
    slots = {name: [i for i in range(n) if i % len(order) == k]
             for k, name in enumerate(order)}
    rng = _rng(seed, 1)
    perm = list(range(n))
    for name in order:
        src = slots[name]
        for dst, j in zip(src, rng.permutation(len(src))):
            perm[dst] = src[j]
    due = mix.poisson_arrivals(n, float(spec["rate_rps"]), seed=pool_seed)
    cap = int(spec["max_new_tokens"])
    return [Arrival(index=i, due_s=float(due[i]), req=reqs[perm[i]],
                    max_new_tokens=budget(reqs[perm[i]].resp_tokens_mean,
                                          cap))
            for i in range(n)]
