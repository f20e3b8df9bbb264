"""Parity of the port's policy-matrix path with the JAX package's, on the
smoke-size session trace (48 requests asked, 47 built; padded to 64): for
every registered policy under each evaluator configuration the matrix uses
(its decision space × clean, straggler on static priors, straggler with
the learned estimators), the port's evaluator gives the reference
evaluator's and both reference DES oracles' assignments exactly; padded
rows equal unpadded ones bit for bit; ``policy_matrix.run(smoke=True)``
gives the reference evaluators' numbers on its genomes; a fit run on the
reference's random draws picks the reference's genome.

Tolerances. Assignments are exact. Inside its jitted scan XLA on the CPU
contracts multiply-add pairs into FMA instructions, one rounding where the
port (and numpy) take two, so the two f32 clocks can part by a last bit: a
response time is completion minus arrival on a clock that runs past 32 s
in this trace (arrivals reach 42 s), where one f32 ulp is 3.8e-6 s.
Per-request rows therefore agree within ``rtol=1e-6, atol=1e-5`` (under
three ulps of the clock), objectives (means, summed in another order)
within ``rtol=1e-6, atol=1e-6``. The DES oracles keep their clocks in
float64 and are held to the reference's own tolerance for them
(``rtol=1e-4, atol=1e-5``, tests/test_faults.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.simulator import ClusterSimulator
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import fitness as rf
from repro.core import nsga2 as rn
from repro.faults import FaultSchedule as RefSchedule
from repro.faults import Straggler as RefStraggler
from repro.learn import LearnConfig as RefLearnConfig
from repro.obs.metrics import Histogram as RefHistogram
from repro.workload.sessions import SessionConfig as RefSessionConfig
from repro.workload.sessions import build_session_trace as ref_sessions
from repro.workload.slo import attach_slos as ref_attach_slos
from repro_torch import policy_matrix as pm
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core import nsga2 as tn
from repro_torch.core.policies import get_policy, list_policies
from repro_torch.obs.metrics import Histogram
from test_torch_online import _replay_evolve_scan

ROW_TOL = dict(rtol=1e-6, atol=1e-5)
OBJ_TOL = dict(rtol=1e-6, atol=1e-6)
DES_TOL = dict(rtol=1e-4, atol=1e-5)
FIELDS = ("q", "cost", "rt", "ttft", "tpot", "hit", "transfer")
CELLS = [(p, r) for p in list_policies() for r in pm.REGIMES]


def _ref_workload(n, seed=0):
    cfg = RefSessionConfig(n_sessions=max(2, n // 3), mean_turns=3.0,
                           session_rate=1.5, think_time_s=3.0)
    tr = ref_sessions(cfg, seed=seed, n_requests=n)
    ref_attach_slos(tr, tightness=pm.TIGHTNESS, seed=seed)
    return tr


def _ref_config(space, regime):
    cfg = rf.EvalConfig(mode="open", prefix_cache=True,
                        disaggregated=space == "route",
                        learned=regime == "straggler_learned",
                        learner=RefLearnConfig())
    sched = (None if regime == "clean" else
             RefSchedule(stragglers=(RefStraggler(0, 0.0, 1e9, 3.0),)))
    return cfg, sched


@functools.lru_cache(maxsize=None)
def _world():
    n = pm.SMOKE_REQUESTS
    tr, ref_tr = pm.workload(n), _ref_workload(n)
    np.testing.assert_array_equal(tr.group_id, ref_tr.group_id)
    evs = pm.evaluators(tr, paper_testbed(), "cpu")
    ref_evs = {}
    for key in evs:
        cfg, sched = _ref_config(*key)
        ref_evs[key] = rf.TraceEvaluator(ref_tr, ref_testbed(), cfg,
                                         bucket="pow2", faults=sched)
    return tr, ref_tr, evs, ref_evs


def _genomes(policy, n_valid, seed=0):
    """The hand defaults and seeded genomes (per-request: assignments)."""
    spec = get_policy(policy).genome_spec
    rng = np.random.default_rng(seed)
    if spec.per_request:
        return rng.integers(0, paper_testbed().n_pairs,
                            (4, n_valid)).astype(np.int32)
    G = spec.lo + rng.random((5, spec.length)) * (spec.hi - spec.lo)
    return np.concatenate([spec.defaults[None], G]).astype(np.float32)


@pytest.mark.parametrize("policy,regime", CELLS)
def test_cell_matches_reference_evaluator_and_des(policy, regime):
    tr, ref_tr, evs, ref_evs = _world()
    space = pm.space_of(policy)
    ev, ref = evs[space, regime], ref_evs[space, regime]
    G = _genomes(policy, tr.n_requests)
    got = ev.run_population(policy, G)
    want = jax.vmap(lambda g: ref.run_policy(policy, g))(jnp.asarray(G))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f, **ROW_TOL)
    np.testing.assert_allclose(got.violation.numpy(),
                               np.asarray(want.violation), **ROW_TOL)
    F, viol = ev.make_fitness(policy, "qoe")(torch.from_numpy(G))
    F_ref, viol_ref = ref.make_fitness(policy, "qoe")(jnp.asarray(G),
                                                      jax.random.key(0))
    assert F.shape == (len(G), 4)
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), **OBJ_TOL)
    np.testing.assert_allclose(viol.numpy(), np.asarray(viol_ref),
                               **OBJ_TOL)
    # the reference's two DES oracles on the defaults and a seeded genome
    cfg, sched = _ref_config(space, regime)
    sim = ClusterSimulator(ref_tr, ref_testbed(), prefix_cache=True,
                           disaggregated=cfg.disaggregated, faults=sched,
                           learned=cfg.learned, learner=cfg.learner)
    for k in range(2):
        for sr in (sim.run(policy=policy, genome=G[k]),
                   sim.run_event_heap(policy=policy, genome=G[k])):
            np.testing.assert_array_equal(got.assign[k].numpy(), sr.assign)
            for f in FIELDS:
                np.testing.assert_allclose(getattr(got, f)[k].numpy(),
                                           getattr(sr, f), err_msg=f,
                                           **DES_TOL)
    assert float(got.hit.max()) > 0     # the prefix cache was hit


@pytest.mark.parametrize("space", pm.SPACES)
@pytest.mark.parametrize("regime", pm.REGIMES)
def test_padded_rows_equal_unpadded(space, regime):
    """The 47 rows padded to 64 (and the cache groups to powers of two):
    every policy's per-request rows bit for bit, zeros and assign -1 on
    the padded rows, objectives within 1e-6 relative (a sum over 64 rows
    may take another tree than over 47)."""
    tr, _, evs, _ = _world()
    padded = evs[space, regime]
    cfg, _ = pm.eval_config(space, regime)
    plain = pm.TraceEvaluator(tr, paper_testbed(), cfg,
                              faults=None if regime == "clean"
                              else pm.STRAGGLER, device="cpu")
    assert (plain.n_padded, padded.n_valid, padded.n_padded) == (47, 47, 64)
    assert plain.n_groups != padded.n_groups
    policies = [p for p in list_policies() if pm.space_of(p) == space]
    if space == "route":
        policies.append("direct")       # per-request genomes index routes
    for policy in policies:
        G = _genomes(policy, tr.n_requests, seed=3)
        a = plain.run_population(policy, G)
        b = padded.run_population(policy, G)
        for f in FIELDS + ("assign",):
            assert torch.equal(getattr(a, f), getattr(b, f)), (policy, f)
        full = padded._run(policy, padded._genomes(policy, G))
        assert bool((full.assign[:, 47:] == -1).all())
        for f in FIELDS:
            assert not getattr(full, f)[:, 47:].any(), (policy, f)
        Fa, va = plain.make_fitness(policy, "qoe")(torch.from_numpy(G))
        Fb, vb = padded.make_fitness(policy, "qoe")(torch.from_numpy(G))
        np.testing.assert_allclose(Fa.numpy(), Fb.numpy(), rtol=1e-6)
        np.testing.assert_allclose(va.numpy(), vb.numpy(), rtol=1e-6)


def test_run_smoke_rows_equal_reference_evaluators():
    """``run(smoke=True)``: every registered policy has a tuned row, and
    every row's numbers are the reference evaluators' on its genome."""
    rows = pm.run(device="cpu", smoke=True)
    _, _, _, ref_evs = _world()
    assert {r.policy for r in rows if r.variant == "tuned"} == \
        set(list_policies())
    assert len(rows) == 2 * len(list_policies()) - 1     # direct: no default
    for r in rows:
        space = pm.space_of(r.policy)
        ref = ref_evs[space, "clean"]
        res = ref.run_policy(r.policy, jnp.asarray(r.genome))
        s = ref.summarize(res)
        h_rt, h_tt = RefHistogram(), RefHistogram()
        h_rt.observe(np.asarray(res.rt, np.float64))
        h_tt.observe(np.asarray(res.ttft, np.float64))
        want = dict(avg_quality=s["avg_quality"], avg_cost=s["avg_cost"],
                    avg_rt_s=s["avg_response_time"],
                    avg_ttft_s=s["avg_ttft"],
                    slo_attainment=s["slo_attainment"],
                    cache_hit_frac=s["cache_hit_frac"],
                    rt_p50_s=h_rt.percentile(50), rt_p95_s=h_rt.percentile(95),
                    rt_p99_s=h_rt.percentile(99),
                    ttft_p99_s=h_tt.percentile(99))
        for regime in ("straggler_static", "straggler_learned"):
            ref_f = ref_evs[space, regime]
            want[f"attain_{regime}"] = ref_f.summarize(ref_f.run_policy(
                r.policy, jnp.asarray(r.genome)))["slo_attainment"]
        for k, v in want.items():
            np.testing.assert_allclose(getattr(r, k), v, err_msg=(r.policy,
                                                                 k),
                                       **ROW_TOL)
        assert r.nsga2_fit_s > 0


@pytest.mark.parametrize("policy", ["affinity", "disagg"])
def test_tuned_genome_on_reference_draws(policy, monkeypatch):
    """The matrix's fit (pop 8 x 4 generations, QoE objectives, the
    weighted pick) run on the reference's random draws: the port picks
    the reference's genome."""
    monkeypatch.setattr(tn.NSGA2, "evolve_scan", _replay_evolve_scan)
    _, _, evs, ref_evs = _world()
    space = pm.space_of(policy)
    genome, fit_s = pm.fit(evs[space, "clean"], policy, pm.SMOKE_POP,
                           pm.SMOKE_GENS, 0, torch.device("cpu"))
    opt = rn.NSGA2(ref_evs[space, "clean"].make_fitness(policy, "qoe"),
                   rn.NSGA2Config.from_policy(policy,
                                              pop_size=pm.SMOKE_POP,
                                              n_generations=pm.SMOKE_GENS))
    state = opt.evolve_scan(jax.random.key(0), pm.SMOKE_GENS)
    want, _ = opt.select_by_weights(state, jnp.asarray(pm.WEIGHTS))
    np.testing.assert_allclose(genome, np.asarray(want), rtol=1e-6)
    assert fit_s > 0


def test_histogram_percentiles_bit_equal():
    rng = np.random.default_rng(2)
    samples = [rng.lognormal(0.0, 1.5, 500), np.zeros(7), np.full(3, 2.5),
               rng.uniform(0, 1e-7, 20), rng.uniform(1e5, 1e7, 30),
               np.asarray([]), np.asarray([0.0, 1e-6, 1e6, 3.3])]
    for vals in samples:
        h, ref = Histogram(), RefHistogram()
        h.observe(vals)
        ref.observe(vals)
        for v in vals[:5]:
            h.observe_one(float(v))
            ref.observe_one(float(v))
        h.observe(float(np.sum(vals[:2])))
        ref.observe(float(np.sum(vals[:2])))
        np.testing.assert_array_equal(h.counts, ref.counts)
        assert (h.n, h.total, h.vmin, h.vmax) == (ref.n, ref.total, ref.vmin,
                                                  ref.vmax)
        got = h.percentiles((0, 1, 50, 90, 95, 99, 100))
        want = ref.percentiles((0, 1, 50, 90, 95, 99, 100))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == want[k] or (np.isnan(got[k])
                                         and np.isnan(want[k])), k
    assert np.isnan(Histogram().percentile(50))
    assert np.isnan(Histogram().mean)
    # exact merges: the same fixed edges everywhere
    parts = [rng.lognormal(0, 1, 40), rng.uniform(0, 3, 25)]
    merged, ref_merged = Histogram(), RefHistogram()
    for vals in parts:
        h, ref = Histogram(), RefHistogram()
        h.observe(vals)
        ref.observe(vals)
        merged.merge(h)
        ref_merged.merge(ref)
    np.testing.assert_array_equal(merged.counts, ref_merged.counts)
    assert merged.percentiles() == ref_merged.percentiles()
    assert merged.mean == ref_merged.mean
