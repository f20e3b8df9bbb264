"""Parity of the port's NSGA-II with the JAX package's: one generation fed
the reference's own ``jax.random`` draws (rebuilt with ``_step_core``'s key
splits) must pick the same parents, make the same offspring and keep the
same survivors. JAX's threefry streams cannot be reproduced in torch, so
whole runs are compared by outcome elsewhere (tests/test_torch_slice.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import nsga2 as rn
from repro.core.fitness import EvalConfig as RefEvalConfig
from repro.core.fitness import TraceEvaluator as RefEvaluator
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core import nsga2 as tn
from repro_torch.core.fitness import EvalConfig, TraceEvaluator
from repro_torch.core.policies.threshold import BOUNDS_HI, BOUNDS_LO
from repro_torch.kernels import dominance
from repro_torch.workload.trace import build_trace

N_REQ = 60
POP = 24
# objectives are f32 sums taken in another order than XLA's (rtol ~1e-6);
# crowding divides differences of neighbouring objectives by the front's
# range, which magnifies that by the ratio of range to gap
CROWD_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _evaluators():
    cfg = dict(concurrency=4, mode="queued")
    return (TraceEvaluator(build_trace(N_REQ, seed=2), paper_testbed(),
                           EvalConfig(**cfg), device="cpu"),
            RefEvaluator(ref_build_trace(N_REQ, seed=2), ref_testbed(),
                         RefEvalConfig(**cfg)))


def _configs(genome):
    if genome == "continuous":
        kw = dict(pop_size=POP, n_generations=2)
        return (tn.NSGA2Config(lo=BOUNDS_LO, hi=BOUNDS_HI, **kw),
                rn.NSGA2Config(lo=jnp.asarray(BOUNDS_LO),
                               hi=jnp.asarray(BOUNDS_HI), **kw))
    kw = dict(pop_size=POP, n_generations=2, genome="discrete", n_choices=10,
              genome_length=N_REQ)
    return tn.NSGA2Config(**kw), rn.NSGA2Config(**kw)


def _reference_draws(key, cfg):
    """The reference's key splits of one generation, as tensors."""
    P, D = cfg.pop_size, cfg.n_genes
    _, k_sel, k_cx, k_mut, _ = jax.random.split(key, 5)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tour = t(jax.random.randint(k_sel, (P, 2), 0, P)).long()
    if cfg.genome == "continuous":
        k_pair, k_gene, k_u = jax.random.split(k_cx, 3)
        cx_u = t(jax.random.uniform(k_u, (P // 2, D)))
    else:
        k_pair, k_gene = jax.random.split(k_cx)
        cx_u = torch.empty((P // 2, 0))
    cx_pair = t(jax.random.uniform(k_pair, (P // 2, 1)))
    cx_gene = t(jax.random.uniform(k_gene, (P // 2, D)))
    k_gate, k_val = jax.random.split(k_mut)
    gate = t(jax.random.uniform(k_gate, (P, D)))
    if cfg.genome == "continuous":
        value = t(jax.random.uniform(k_val, (P, D)))
    else:
        value = t(jax.random.randint(k_val, (P, D), 0, cfg.n_choices,
                                     dtype=jnp.int32))
    return tn.StepDraws(tour, cx_pair, cx_gene, cx_u, gate, value), k_sel, \
        k_cx, k_mut


@pytest.mark.parametrize("genome,policy", [("continuous", "threshold"),
                                           ("discrete", "direct")])
def test_one_step_on_reference_draws(genome, policy):
    ev, ref_ev = _evaluators()
    cfg, ref_cfg = _configs(genome)
    ref_opt = rn.NSGA2(ref_ev.make_fitness(policy), ref_cfg)
    ref_state = ref_opt.init(jax.random.key(3))
    opt = tn.NSGA2(ev.make_fitness(policy), cfg, device="cpu")
    # the port scores the reference's initial genomes itself: objectives
    # from two summation orders must not meet in one population, where an
    # ulp would break a tie between equal routings
    state = opt.init(torch.Generator(), archive=ref_state.genomes)
    np.testing.assert_array_equal(state.genomes.numpy(),
                                  np.asarray(ref_state.genomes))
    np.testing.assert_array_equal(state.rank.numpy(),
                                  np.asarray(ref_state.rank))
    np.testing.assert_allclose(state.crowd.numpy(),
                               np.asarray(ref_state.crowd), rtol=CROWD_RTOL)
    draws, k_sel, k_cx, k_mut = _reference_draws(ref_state.key, ref_cfg)

    # tournaments: exact
    parents = tn.binary_tournament(draws.tournament, state.rank, state.crowd)
    ref_parents = rn.binary_tournament(k_sel, ref_state.rank,
                                       ref_state.crowd, POP)
    np.testing.assert_array_equal(parents.numpy(), np.asarray(ref_parents))

    # variation on the same parents
    pg, ref_pg = state.genomes[parents], ref_state.genomes[ref_parents]
    if genome == "continuous":
        lo, hi = torch.from_numpy(BOUNDS_LO), torch.from_numpy(BOUNDS_HI)
        c = tn.sbx_crossover(draws.cx_pair, draws.cx_gene, draws.cx_u,
                             pg[0::2], pg[1::2], lo, hi, cfg.crossover_prob,
                             cfg.eta_crossover)
        rc = rn.sbx_crossover(k_cx, ref_pg[0::2], ref_pg[1::2], ref_cfg.lo,
                              ref_cfg.hi, cfg.crossover_prob,
                              cfg.eta_crossover)
        off = tn.polynomial_mutation(draws.mut_gate, draws.mut_value,
                                     torch.cat(c), lo, hi,
                                     cfg.mutation_prob, cfg.eta_mutation)
        roff = rn.polynomial_mutation(k_mut, jnp.concatenate(rc), ref_cfg.lo,
                                      ref_cfg.hi, cfg.mutation_prob,
                                      cfg.eta_mutation)
        # pow may differ by an ulp between XLA and torch
        for a, b in zip(c, rc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_allclose(off.numpy(), np.asarray(roff), rtol=1e-6)
    else:
        c = tn.uniform_swap_crossover(draws.cx_pair, draws.cx_gene, pg[0::2],
                                      pg[1::2], cfg.crossover_prob)
        rc = rn.uniform_swap_crossover(k_cx, ref_pg[0::2], ref_pg[1::2],
                                       cfg.crossover_prob)
        off = tn.reassignment_mutation(draws.mut_gate, draws.mut_value,
                                       torch.cat(c), cfg.mutation_prob)
        roff = rn.reassignment_mutation(k_mut, jnp.concatenate(rc),
                                        cfg.mutation_prob, cfg.n_choices)
        for a, b in zip(c, rc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(off.numpy(), np.asarray(roff))
        assert off.dtype == torch.int32

    # the whole generation: the same survivors in the same order
    before = dominance.LAUNCHES
    nxt = opt.step(state, draws)
    ref_nxt = ref_opt._step(ref_state)
    assert dominance.LAUNCHES == before     # CPU tensors take the plain path
    assert nxt.generation == 1
    np.testing.assert_array_equal(nxt.rank.numpy(), np.asarray(ref_nxt.rank))
    np.testing.assert_allclose(nxt.genomes.numpy(),
                               np.asarray(ref_nxt.genomes), rtol=1e-6)
    np.testing.assert_allclose(nxt.F_raw.numpy(), np.asarray(ref_nxt.F_raw),
                               rtol=1e-5)
    np.testing.assert_allclose(nxt.crowd.numpy(), np.asarray(ref_nxt.crowd),
                               rtol=CROWD_RTOL)
    # the same pick from the same population
    w = np.array([1 / 3, 1 / 3, 1 / 3], np.float32)
    g, f = opt.select_by_weights(nxt, w)
    rg, rf = ref_opt.select_by_weights(ref_nxt, jnp.asarray(w))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6)


def test_penalty_matches_reference():
    rng = np.random.default_rng(0)
    F = rng.random((16, 3)).astype(np.float32)
    v = np.where(rng.random(16) < 0.5, rng.random(16) * 3, 0).astype(
        np.float32)
    np.testing.assert_array_equal(
        tn._penalize(torch.from_numpy(F), torch.from_numpy(v)).numpy(),
        np.asarray(rn._penalize(jnp.asarray(F), jnp.asarray(v))))


def _zdt1(genomes):
    f1 = genomes[:, 0]
    g = 1 + 9 * genomes[:, 1:].mean(dim=1)
    f2 = g * (1 - torch.sqrt(f1 / g))
    return torch.stack([f1, f2], dim=1), torch.zeros(genomes.shape[0])


def test_evolve_converges_and_kernel_flag_is_the_same_function():
    """Survival goes through ``kernels.ops``, whose CPU branch is the
    kernel's plain version: a CPU run converges and launches nothing."""
    D = 8
    cfg = tn.NSGA2Config(pop_size=48, n_generations=90, lo=np.zeros(D),
                         hi=np.ones(D))
    opt = tn.NSGA2(_zdt1, cfg, device="cpu")
    before = dominance.LAUNCHES
    a = opt.evolve_scan(torch.Generator().manual_seed(0))
    assert dominance.LAUNCHES == before     # CPU tensors take the plain path
    g = 1 + 9 * a.genomes[:, 1:].mean(dim=1)
    assert float(g.mean()) < 1.5            # optimum g = 1, random init ≈ 5.5
    front_g, front_F = opt.pareto_front(a)
    assert front_F.shape[0] > 0 and front_g.shape[1] == D


def test_archive_warm_start_and_callback():
    D = 4
    cfg = tn.NSGA2Config(pop_size=8, n_generations=2, lo=np.zeros(D),
                         hi=np.ones(D))
    opt = tn.NSGA2(_zdt1, cfg, device="cpu")
    archive = torch.full((3, D), 2.0)       # clipped into the bounds
    s0 = opt.init(torch.Generator().manual_seed(1), archive=archive)
    assert torch.equal(s0.genomes[:3], torch.ones(3, D))
    seen = []
    opt.evolve(torch.Generator().manual_seed(1), 3, callback=seen.append)
    assert [s.generation for s in seen] == [1, 2, 3]


def test_discrete_default_init_uses_genome_length():
    cfg = tn.NSGA2Config(pop_size=8, n_generations=2, genome="discrete",
                         n_choices=7, genome_length=53)
    fit = lambda g: (torch.stack([g.float().mean(1), -g.float().mean(1)], 1),  # noqa: E731
                     torch.zeros(g.shape[0]))
    s = tn.NSGA2(fit, cfg, device="cpu").evolve(
        torch.Generator().manual_seed(0), 2)
    assert s.genomes.shape == (8, 53) and s.genomes.dtype == torch.int32
    assert int(s.genomes.min()) >= 0 and int(s.genomes.max()) < 7
