"""NSGA-II (Deb et al. 2002) on tensors: the paper's §IV optimizer.

A population of routing policies evolved with non-dominated sorting and
crowding distance, binary tournament selection, crossover and mutation. Two
genome encodings, matching the paper's two policy representations:

* **continuous** (threshold genome, §IV-B.6): D decision variables in
  ``[lo, hi]`` — SBX crossover + polynomial mutation;
* **discrete** (direct assignment genome, §IV-B.1): one int32 gene per
  request selecting a (node, model) pair — uniform-swap crossover + random
  reassignment mutation.

The port of ``repro.core.nsga2``. JAX's keys become a ``torch.Generator``;
its threefry streams cannot be reproduced, so every operator takes its
random draws as explicit tensors. :class:`StepDraws` draws them for one
generation in the split structure of the reference's ``_step_core``, so a
test can hand the operators the reference's own ``jax.random`` draws.

Constraints are folded into a penalty: infeasible individuals get every
objective shifted by ``PENALTY + violation * PENALTY``, so every feasible
point dominates them while infeasible points stay ordered by violation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import Device, resolve
from .pareto import crowding_distance, lexsort, non_dominated_sort

PENALTY = 1e6

# FitnessFn: genomes (P, D) -> (F (P, M), violation (P,))
FitnessFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    """Hyper-parameters (paper §V-A: P=100, T=100, pc=0.8, pm=0.1)."""

    pop_size: int = 100
    n_generations: int = 100
    crossover_prob: float = 0.8
    mutation_prob: float = 0.1
    eta_crossover: float = 15.0
    eta_mutation: float = 20.0
    genome: str = "continuous"  # "continuous" | "discrete"
    # continuous bounds (D,) arrays; discrete cardinality + genome length
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    n_choices: int = 0
    genome_length: int = 0

    def __post_init__(self):
        assert self.pop_size % 2 == 0, "pop_size must be even"
        assert self.genome in ("continuous", "discrete")

    @classmethod
    def from_policy(cls, policy, **overrides) -> "NSGA2Config":
        """Derive the genome encoding from a registered RoutingPolicy.

        ``policy`` is a registry name or RoutingPolicy object. Continuous
        policies contribute their search bounds (D = GenomeSpec.length, so
        genome-length defaults cannot drift from the decision rule);
        discrete per-request policies ("direct") set ``genome="discrete"``
        and require the caller to pass trace-dependent ``genome_length`` /
        ``n_choices`` via ``overrides``. Other NSGA-II hyper-parameters
        (pop_size, n_generations, ...) pass through ``overrides``.
        """
        from .policies import get_policy
        pol = get_policy(policy) if isinstance(policy, str) else policy
        spec = pol.genome_spec
        if spec.discrete:
            overrides.setdefault("genome", "discrete")
            return cls(**overrides)
        overrides.setdefault("genome", "continuous")
        overrides.setdefault("lo", np.asarray(spec.lo))
        overrides.setdefault("hi", np.asarray(spec.hi))
        return cls(**overrides)

    @property
    def n_genes(self) -> int:
        """Genome dimensionality D implied by the config."""
        if self.genome == "continuous":
            assert self.lo is not None, "continuous genome requires bounds"
            return int(len(self.lo))
        assert self.genome_length > 0, \
            "discrete genome requires genome_length (or a custom init_fn)"
        return self.genome_length


class NSGA2State(NamedTuple):
    genomes: torch.Tensor     # (P, D) float32 or int32
    F: torch.Tensor           # (P, M) penalized objectives
    F_raw: torch.Tensor       # (P, M) unpenalized objectives
    violation: torch.Tensor   # (P,)
    rank: torch.Tensor        # (P,) int32
    crowd: torch.Tensor       # (P,)
    generation: int = 0


def _penalize(F: torch.Tensor, violation: torch.Tensor) -> torch.Tensor:
    return F + (violation[:, None] > 0) * (PENALTY + violation[:, None] * PENALTY)


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------

class StepDraws(NamedTuple):
    """Every random number one generation consumes, in the order of the
    reference's key splits: tournament, crossover (pair gate, gene gate,
    SBX u), mutation (gate, value)."""

    tournament: torch.Tensor  # (P, 2) int64 indices into the population
    cx_pair: torch.Tensor     # (P/2, 1) uniform: crossover applies if < pc
    cx_gene: torch.Tensor     # (P/2, D) uniform: per-gene 0.5 gate
    cx_u: torch.Tensor        # (P/2, D) uniform SBX spread (continuous)
    mut_gate: torch.Tensor    # (P, D) uniform: mutate if < pm
    mut_value: torch.Tensor   # (P, D) uniform u (continuous) or int32 gene

    @classmethod
    def sample(cls, generator: torch.Generator, cfg: NSGA2Config, D: int,
               device: torch.device) -> "StepDraws":
        P, half = cfg.pop_size, cfg.pop_size // 2

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)

        tournament = torch.randint(0, P, (P, 2), generator=generator,
                                   device=device)
        cx_pair, cx_gene = uniform(half, 1), uniform(half, D)
        if cfg.genome == "continuous":
            cx_u = uniform(half, D)
            mut_gate, mut_value = uniform(P, D), uniform(P, D)
        else:
            cx_u = torch.empty((half, 0), device=device)
            mut_gate = uniform(P, D)
            mut_value = torch.randint(0, cfg.n_choices, (P, D),
                                      generator=generator, device=device,
                                      dtype=torch.int32)
        return cls(tournament, cx_pair, cx_gene, cx_u, mut_gate, mut_value)


# ---------------------------------------------------------------------------
# Variation operators
# ---------------------------------------------------------------------------

def sbx_crossover(cx_pair: torch.Tensor, cx_gene: torch.Tensor,
                  u: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor, pc: float, eta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated binary crossover on (n_pairs, D) parent blocks."""
    beta = torch.where(
        u <= 0.5,
        (2.0 * u) ** (1.0 / (eta + 1.0)),
        (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (eta + 1.0)),
    )
    c1 = 0.5 * ((1.0 + beta) * p1 + (1.0 - beta) * p2)
    c2 = 0.5 * ((1.0 - beta) * p1 + (1.0 + beta) * p2)
    # per-gene 0.5 exchange, per-pair pc gate
    apply = (cx_pair < pc) & (cx_gene < 0.5)
    c1 = torch.where(apply, c1, p1)
    c2 = torch.where(apply, c2, p2)
    return torch.clamp(c1, lo, hi), torch.clamp(c2, lo, hi)


def polynomial_mutation(gate: torch.Tensor, u: torch.Tensor, x: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor, pm: float,
                        eta: float) -> torch.Tensor:
    """Polynomial mutation on (P, D)."""
    delta = torch.where(
        u < 0.5,
        (2.0 * u) ** (1.0 / (eta + 1.0)) - 1.0,
        1.0 - (2.0 * (1.0 - u)) ** (1.0 / (eta + 1.0)),
    )
    mutated = x + delta * (hi - lo)
    return torch.clamp(torch.where(gate < pm, mutated, x), lo, hi)


def uniform_swap_crossover(cx_pair: torch.Tensor, cx_gene: torch.Tensor,
                           p1: torch.Tensor, p2: torch.Tensor, pc: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper §IV-B.4: swap node-LLM pairs for a subset of requests."""
    swap = (cx_gene < 0.5) & (cx_pair < pc)
    return torch.where(swap, p2, p1), torch.where(swap, p1, p2)


def reassignment_mutation(gate: torch.Tensor, fresh: torch.Tensor,
                          x: torch.Tensor, pm: float) -> torch.Tensor:
    """Paper §IV-B.4: reassign a small fraction of requests to other pairs
    (``fresh`` holds the new pair of every gene)."""
    return torch.where(gate < pm, fresh.to(x.dtype), x)


# ---------------------------------------------------------------------------
# Warm start
# ---------------------------------------------------------------------------

def archive_init(archive, cfg: NSGA2Config
                 ) -> Callable[[torch.Generator], torch.Tensor]:
    """``init_fn`` seeding a population from an elite archive (warm start).

    The first ``min(len(archive), pop_size)`` individuals are copied from the
    archive (a previous run's survival-ordered population or Pareto front —
    ``NSGA2State.genomes`` rows are already sorted best-first by
    (rank, -crowding)); the remainder is drawn from the default random init
    on the generator's device, so the restarted search keeps exploring.
    ``NSGA2.init(archive=)`` does the same for the default init.
    """
    archive = torch.as_tensor(archive)
    assert archive.dim() == 2, "archive must be (A, D) genomes"
    n_seed = min(archive.shape[0], cfg.pop_size)

    def init_fn(generator: torch.Generator) -> torch.Tensor:
        dev = generator.device
        shape = (cfg.pop_size, cfg.n_genes)
        if cfg.genome == "continuous":
            lo, hi = (torch.as_tensor(np.asarray(b), dtype=torch.float32,
                                      device=dev) for b in (cfg.lo, cfg.hi))
            u = torch.rand(shape, generator=generator, device=dev)
            fresh = lo + u * (hi - lo)
            seeds = torch.clamp(archive[:n_seed].to(dev, fresh.dtype), lo, hi)
        else:
            fresh = torch.randint(0, cfg.n_choices, shape,
                                  generator=generator, device=dev,
                                  dtype=torch.int32)
            seeds = archive[:n_seed].to(dev, torch.int32)
        fresh[:n_seed] = seeds
        return fresh

    return init_fn


# ---------------------------------------------------------------------------
# Selection / survival
# ---------------------------------------------------------------------------

def binary_tournament(idx: torch.Tensor, rank: torch.Tensor,
                      crowd: torch.Tensor) -> torch.Tensor:
    """(n,) winners of the n binary tournaments between idx[:, 0] and
    idx[:, 1]."""
    a, b = idx[:, 0], idx[:, 1]
    a_better = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (crowd[a] > crowd[b]))
    return torch.where(a_better, a, b)


def survival_select(F: torch.Tensor, P: int, top: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elitist (μ+λ) truncation: top-P of the combined population by
    (rank asc, crowding desc). Returns (indices, rank_sel, crowd_sel).

    The sort's dominance matrix comes from ``kernels.ops`` (the CUDA kernel
    for CUDA tensors); ``top`` is the sort's early-exit quota."""
    rank = non_dominated_sort(F, top=top)
    crowd = crowding_distance(F, rank)
    neg_crowd = torch.where(torch.isinf(crowd), float("-inf"), -crowd)
    sel = lexsort(neg_crowd, rank)[:P]
    return sel, rank[sel], crowd[sel]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class NSGA2:
    """NSGA-II engine over a population-batched fitness function.

    Parameters
    ----------
    fitness_fn : maps (P, D) genomes -> (objectives (P, M), violation (P,)).
        Objectives are minimized.
    config : NSGA2Config
    init_fn : optional population initializer (generator) -> (P, D) genomes;
        defaults to uniform in bounds / uniform categorical.
    device : where genomes live (CUDA unless the caller asks). The survival
        dominance matrix follows the objectives' device: the CUDA kernel on
        the card, its plain version on the CPU.
    """

    def __init__(self, fitness_fn: FitnessFn, config: NSGA2Config,
                 init_fn: Optional[Callable[[torch.Generator],
                                            torch.Tensor]] = None,
                 device: Device = None):
        self.fitness_fn = fitness_fn
        self.config = config
        self.init_fn = init_fn
        self.device = resolve(device)
        if config.genome == "continuous" and config.lo is not None:
            self._lo, self._hi = (
                torch.as_tensor(np.asarray(b), dtype=torch.float32,
                                device=self.device)
                for b in (config.lo, config.hi))
        else:
            self._lo = self._hi = None

    def _evaluate(self, genomes: torch.Tensor):
        F_raw, violation = self.fitness_fn(genomes)
        return _penalize(F_raw, violation), F_raw, violation

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator,
             archive: Optional[torch.Tensor] = None) -> NSGA2State:
        cfg = self.config
        if self.init_fn is not None:
            genomes = self.init_fn(generator)
        elif cfg.genome == "continuous":
            u = torch.rand((cfg.pop_size, cfg.n_genes), generator=generator,
                           device=self.device)
            genomes = self._lo + u * (self._hi - self._lo)
        else:
            if cfg.n_choices <= 0:
                raise ValueError("discrete genome requires init_fn or "
                                 "n_choices>0")
            genomes = torch.randint(0, cfg.n_choices,
                                    (cfg.pop_size, cfg.n_genes),
                                    generator=generator, device=self.device,
                                    dtype=torch.int32)
        if archive is not None:
            # warm start: the first rows come from a previous run's
            # survival-ordered genomes, the rest stay random
            archive = torch.as_tensor(archive, device=self.device)
            n_seed = min(archive.shape[0], cfg.pop_size)
            seeds = archive[:n_seed].to(genomes.dtype)
            if cfg.genome == "continuous":
                seeds = torch.clamp(seeds, self._lo, self._hi)
            genomes = genomes.clone()
            genomes[:n_seed] = seeds
        F, F_raw, violation = self._evaluate(genomes)
        rank = non_dominated_sort(F)
        crowd = crowding_distance(F, rank)
        return NSGA2State(genomes, F, F_raw, violation, rank, crowd, 0)

    # -- one generation -------------------------------------------------------
    def step(self, state: NSGA2State, draws: StepDraws) -> NSGA2State:
        cfg = self.config
        P = cfg.pop_size
        parents = binary_tournament(draws.tournament, state.rank, state.crowd)
        pg = state.genomes[parents]
        p1, p2 = pg[0::2], pg[1::2]

        if cfg.genome == "continuous":
            c1, c2 = sbx_crossover(draws.cx_pair, draws.cx_gene, draws.cx_u,
                                   p1, p2, self._lo, self._hi,
                                   cfg.crossover_prob, cfg.eta_crossover)
            offspring = polynomial_mutation(
                draws.mut_gate, draws.mut_value, torch.cat([c1, c2]),
                self._lo, self._hi, cfg.mutation_prob, cfg.eta_mutation)
        else:
            c1, c2 = uniform_swap_crossover(draws.cx_pair, draws.cx_gene,
                                            p1, p2, cfg.crossover_prob)
            offspring = reassignment_mutation(
                draws.mut_gate, draws.mut_value, torch.cat([c1, c2]),
                cfg.mutation_prob)

        F_off, F_off_raw, viol_off = self._evaluate(offspring)

        # (μ+λ) combine + survival (ranks beyond the top-P cutoff early-exit)
        genomes_all = torch.cat([state.genomes, offspring])
        F_all = torch.cat([state.F, F_off])
        F_raw_all = torch.cat([state.F_raw, F_off_raw])
        viol_all = torch.cat([state.violation, viol_off])
        sel, rank_sel, crowd_sel = survival_select(F_all, P, top=P)
        return NSGA2State(
            genomes=genomes_all[sel], F=F_all[sel], F_raw=F_raw_all[sel],
            violation=viol_all[sel], rank=rank_sel, crowd=crowd_sel,
            generation=state.generation + 1)

    # -- drivers --------------------------------------------------------------
    def evolve(self, generator: torch.Generator,
               n_generations: Optional[int] = None,
               callback: Optional[Callable[[NSGA2State], None]] = None,
               archive: Optional[torch.Tensor] = None) -> NSGA2State:
        """Init plus T generations; ``callback`` sees every state and
        ``archive`` warm-starts the population."""
        state = self.init(generator, archive)
        T = (n_generations if n_generations is not None
             else self.config.n_generations)
        for _ in range(T):
            draws = StepDraws.sample(generator, self.config,
                                     state.genomes.shape[1], self.device)
            state = self.step(state, draws)
            if callback is not None:
                callback(state)
        return state

    def evolve_scan(self, generator: torch.Generator,
                    n_generations: Optional[int] = None,
                    archive: Optional[torch.Tensor] = None) -> NSGA2State:
        """The reference's one-program run; here the same loop as
        :meth:`evolve`."""
        return self.evolve(generator, n_generations, archive=archive)

    # -- results --------------------------------------------------------------
    def pareto_front(self, state: NSGA2State
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Feasible rank-0 members: (genomes, raw objectives)."""
        mask = (state.rank == 0) & (state.violation <= 0)
        return state.genomes[mask], state.F_raw[mask]

    def select_index(self, state: NSGA2State, weights) -> int:
        """Index of the policy the paper's Eq. (1) weighted sum over min-max
        normalized objectives (ω1 RQ + ω2 C + ω3 RT, and ω4 V under the
        QoE fitness) picks from the feasible front."""
        F = state.F_raw
        w = torch.as_tensor(weights, dtype=F.dtype, device=F.device)
        fmin = F.min(dim=0).values
        fmax = F.max(dim=0).values
        Fn = (F - fmin) / torch.where(fmax - fmin <= 0, 1.0, fmax - fmin)
        score = Fn @ w
        bad = (state.rank != 0) | (state.violation > 0)
        score = torch.where(bad, float("inf"), score)
        return int(torch.argmin(score))

    def select_by_weights(self, state: NSGA2State, weights
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        i = self.select_index(state, weights)
        return state.genomes[i], state.F_raw[i]
