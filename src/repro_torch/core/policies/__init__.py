"""Pluggable RoutingPolicy registry (the port of ``repro.core.policies``).

One registry drives the evaluator (``core.fitness``) and the NSGA-II genome
configuration. Adding a policy is one file in this package: subclass
:class:`~repro_torch.core.policies.base.RoutingPolicy` and call
:func:`register_policy` at module bottom; modules here are imported in
sorted name order on first import. The registry holds the reference's
nine policies: ``threshold`` (paper Alg. 2), ``direct`` (one gene per
request), ``slo``, ``affinity`` (prefix-cache aware), ``p2c-hedge``,
``budget`` (per-window spend ledger), ``bandit`` (learned quality rows),
``resilient`` (brownout under faults) and the route-valued ``disagg``; the
runtime router takes every one but ``direct`` (:func:`runtime_policies`).
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, Tuple

from .base import GenomeSpec, PolicyInputs, RoutingPolicy  # noqa: F401

_REGISTRY: Dict[str, RoutingPolicy] = {}


def register_policy(policy: RoutingPolicy) -> RoutingPolicy:
    """Register ``policy`` under ``policy.name``. Idempotent for the same
    type (module reloads); a different type under a taken name is an
    error."""
    assert policy.name, "policy must set a non-empty name"
    prev = _REGISTRY.get(policy.name)
    if prev is not None and type(prev) is not type(policy):
        raise ValueError(f"policy name {policy.name!r} already registered "
                         f"by {type(prev).__name__}")
    _REGISTRY[policy.name] = policy
    return policy


def get_policy(name: str) -> RoutingPolicy:
    """Resolve a policy by registry name; ``ValueError`` naming every
    registered policy on unknown input."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown routing policy {name!r}; registered policies: "
            f"{', '.join(list_policies())}") from None


def list_policies() -> Tuple[str, ...]:
    """Sorted names of every registered policy."""
    return tuple(sorted(_REGISTRY))


def runtime_policies() -> Tuple[str, ...]:
    """Policies that can drive the runtime router (fixed-length genomes;
    excludes per-request encodings like "direct")."""
    return tuple(n for n in list_policies()
                 if not _REGISTRY[n].genome_spec.per_request)


for _info in sorted(pkgutil.iter_modules(__path__), key=lambda m: m.name):
    if _info.name != "base" and not _info.name.startswith("_"):
        importlib.import_module(f"{__name__}.{_info.name}")
del _info

__all__ = ["GenomeSpec", "PolicyInputs", "RoutingPolicy", "register_policy",
           "get_policy", "list_policies", "runtime_policies"]
