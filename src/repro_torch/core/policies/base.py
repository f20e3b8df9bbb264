"""RoutingPolicy API: the unit of extension for routing decision rules.

The port of ``repro.core.policies.base``. A policy owns:

* ``name`` — the registry key every consumer dispatches on;
* ``genome_spec`` — length, bounds, defaults, and the discrete/per-request
  flags of the decision-variable vector NSGA-II searches;
* ``requires`` — which inputs the decision actually reads ("features",
  "estimates", "deadlines", "cache", "transfer", "quality");
* ``decide_torch`` / ``decide_py`` — twin implementations of the decision.
  ``decide_torch`` decides for a whole population at once: ``genomes`` is
  (P, D) and every live-state input carries a leading P dimension, so the
  evaluator's per-request step is one batch of tensor ops for all genomes.
  ``decide_py`` is an independent transcription for one genome, the oracle
  the tests hold ``decide_torch`` against. The two mirror each other in
  float32 so tie-breaking is identical;
* optional per-policy state (``state_size`` > 0 with ``update_torch`` /
  ``update_py``): a small float32 vector per genome threaded through the
  evaluation in dispatch order. Stateless policies keep the no-op hooks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


class PolicyInputs(NamedTuple):
    """Uniform decision context for one request.

    Request scalars are 0-d; per-pair vectors are ``(n_pairs,)``. The live
    state ``queue_len`` is per node: ``(P, n_nodes)`` inside the evaluator,
    one row per genome, and ``(n_nodes,)`` for ``decide_py``.
    """

    index: int                 # request index (monotone at runtime)
    now: Array                 # float32 decision timestamp, (P,) in the evaluator
    # classifier features
    complexity: Array          # float32 c_i
    pred_category: Array       # int32 (0=code, 1=math, 2=general)
    pred_conf: Array           # float32
    # QoE contract (+inf when the request carries no SLOs)
    ttft_deadline: Array       # float32 seconds
    tpot_deadline: Array       # float32 s/token
    prompt_tokens: Array       # float32
    # per-pair estimate rows (the request's row of the precomputed tables)
    up: Array                  # (n_pairs,) upload seconds
    prefill: Array             # (n_pairs,) prefill seconds
    tpot: Array                # (n_pairs,) decode seconds per output token
    cost: Array                # (n_pairs,) full-request $ cost
    prompt_cost: Array         # (n_pairs,) prompt-only $ cost
    hit_frac: Array            # (n_pairs,) expected cached-prefix fraction
    # live cluster state
    queue_len: Array           # (P, n_nodes) busy execution slots
    kv_bytes: Array = np.float32(0.0)   # (n_pairs,) KV bytes to move
    quality: Array = np.float32(0.0)    # (n_pairs,) expected quality
    unc: Array = np.float32(0.0)        # (n_pairs,) estimator uncertainty


@dataclasses.dataclass(frozen=True)
class GenomeSpec:
    """Shape/bounds contract of a policy's decision-variable vector.

    ``per_request=True`` marks genomes with one gene per trace request
    (the direct-assignment encoding): their length is trace-dependent
    (``length`` is -1).
    """

    names: Tuple[str, ...] = ()
    lo: Optional[np.ndarray] = None       # (D,) float32 search bounds
    hi: Optional[np.ndarray] = None
    defaults: Optional[np.ndarray] = None  # (D,) sensible hand defaults
    discrete: bool = False
    per_request: bool = False

    def __post_init__(self):
        if not self.per_request:
            assert self.lo is not None and self.hi is not None, \
                "fixed-length genomes need search bounds"
            assert len(self.lo) == len(self.hi) == len(self.names)
            if self.defaults is not None:
                assert len(self.defaults) == len(self.names)

    @property
    def length(self) -> int:
        """Genome dimensionality D; -1 when per-request (trace-dependent)."""
        return -1 if self.per_request else len(self.names)


class RoutingPolicy:
    """Base class; subclasses override the class attributes + decide twins.

    ``decide_torch`` receives ``(genomes (P, D), inp, arrays, state (P, S))``
    and returns (P,) int64 pair indices; ``decide_py`` receives one genome
    and returns an int. ``update_*`` receive ``(genome, state, inp, pair,
    cost)`` and return the next state. Default hooks are stateless no-ops.
    """

    name: str = ""
    genome_spec: GenomeSpec = GenomeSpec(per_request=True)
    requires: frozenset = frozenset()
    state_size: int = 0

    # -- decisions -----------------------------------------------------------
    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        raise NotImplementedError

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        raise NotImplementedError

    # -- optional per-policy state -------------------------------------------
    def init_state(self) -> np.ndarray:
        return np.zeros((self.state_size,), np.float32)

    def update_torch(self, genomes, state, inp: PolicyInputs, pair, cost):
        return state

    def update_py(self, genome, state, inp: PolicyInputs, pair: int,
                  cost: float) -> np.ndarray:
        return state

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<RoutingPolicy {self.name!r} D={self.genome_spec.length}>"
