"""Pluggable RoutingPolicy registry (the port of ``repro.core.policies``).

One registry drives the evaluator (``core.fitness``) and the NSGA-II genome
configuration. Adding a policy is one file in this package: subclass
:class:`~repro_torch.core.policies.base.RoutingPolicy` and call
:func:`register_policy` at module bottom; modules here are imported in
sorted name order on first import. The port has ``threshold`` (paper
Alg. 2) and ``direct`` (one gene per request) so far.
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


for _info in sorted(pkgutil.iter_modules(__path__), key=lambda m: m.name):
    if _info.name != "base" and not _info.name.startswith("_"):
        importlib.import_module(f"{__name__}.{_info.name}")
del _info

__all__ = ["GenomeSpec", "PolicyInputs", "RoutingPolicy", "register_policy",
           "get_policy", "list_policies"]
