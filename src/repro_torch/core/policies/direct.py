"""Direct-assignment policy (paper §IV-B.1): one integer gene per request.

The genome *is* the routing solution — gene i selects request i's
(node, model) pair. This is the discrete NSGA-II encoding (uniform-swap
crossover + reassignment mutation). Genomes are int32, as in the reference;
decisions come out as int64 for indexing.
"""
from __future__ import annotations

from . import register_policy
from .base import GenomeSpec, PolicyInputs, RoutingPolicy


class DirectPolicy(RoutingPolicy):
    name = "direct"
    genome_spec = GenomeSpec(discrete=True, per_request=True)
    requires = frozenset()

    def decide_torch(self, genomes, inp: PolicyInputs, arrays, state):
        return genomes[:, inp.index].long()

    def decide_py(self, genome, inp: PolicyInputs, arrays, state) -> int:
        return int(genome[int(inp.index)])


register_policy(DirectPolicy())
