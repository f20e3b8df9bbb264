"""Back-compat shim: the counterpart of ``repro.core.policy``.

The policy implementations live in ``core.policies``, one registered
``RoutingPolicy`` module each; this module keeps every public name of the
reference's shim importable from here. The reference's ``_jnp`` deciders
are the port's batched torch deciders (``decide_pair_torch`` and its
siblings, which take a (P, D) batch of genomes where the reference's take
one), exported under both names.
"""
from __future__ import annotations

from .policies.affinity import (AFFINITY_BOUNDS_HI, AFFINITY_BOUNDS_LO,
                                AFFINITY_DEFAULTS, AFFINITY_PARAM_NAMES,
                                CACHED_TOKEN_PRICE_FACTOR,
                                decide_pair_affinity_py,
                                decide_pair_affinity_torch)
from .policies.slo import (SLO_BOUNDS_HI, SLO_BOUNDS_LO, SLO_DEFAULTS,
                           SLO_PARAM_NAMES, _slo_scores_np,
                           decide_pair_slo_py, decide_pair_slo_torch)
from .policies.threshold import (BOUNDS_HI, BOUNDS_LO, CAT_CODE, CAT_GENERAL,
                                 CAT_MATH, PAPER_DEFAULTS, THRESHOLD_NAMES,
                                 TYPE_CODER, TYPE_INSTRUCT, TYPE_MATH,
                                 Thresholds, decide_pair_py,
                                 decide_pair_torch)

decide_pair_jnp = decide_pair_torch
decide_pair_slo_jnp = decide_pair_slo_torch
decide_pair_affinity_jnp = decide_pair_affinity_torch

__all__ = [
    "THRESHOLD_NAMES", "BOUNDS_LO", "BOUNDS_HI", "PAPER_DEFAULTS",
    "Thresholds", "decide_pair_jnp", "decide_pair_py",
    "CAT_CODE", "CAT_MATH", "CAT_GENERAL",
    "TYPE_INSTRUCT", "TYPE_CODER", "TYPE_MATH",
    "SLO_PARAM_NAMES", "SLO_BOUNDS_LO", "SLO_BOUNDS_HI", "SLO_DEFAULTS",
    "decide_pair_slo_jnp", "decide_pair_slo_py", "_slo_scores_np",
    "AFFINITY_PARAM_NAMES", "AFFINITY_BOUNDS_LO", "AFFINITY_BOUNDS_HI",
    "AFFINITY_DEFAULTS", "CACHED_TOKEN_PRICE_FACTOR",
    "decide_pair_affinity_jnp", "decide_pair_affinity_py",
    "decide_pair_torch", "decide_pair_slo_torch",
    "decide_pair_affinity_torch",
]
