"""Parity of the port's population fitness with the JAX package's
``TraceEvaluator``: the same genomes over the same trace must give exactly
the same routing assignments, and objectives, per-request outcomes and
violation within f32 summation-order tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import objectives as ref_obj
from repro.core.fitness import EvalConfig as RefEvalConfig
from repro.core.fitness import TraceEvaluator as RefEvaluator
from repro.core.policies.threshold import decide_pair_jnp
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core.fitness import EvalConfig, TraceEvaluator
from repro_torch.core.objectives import (aggregate, aggregate_qoe,
                                         overall_scores, slo_attainment,
                                         slo_ok, weighted_scalar)
from repro_torch.core.policies import get_policy, list_policies
from repro_torch.core.policies.threshold import (BOUNDS_HI, BOUNDS_LO,
                                                 PAPER_DEFAULTS,
                                                 decide_pair_py,
                                                 decide_pair_torch)
from repro_torch.workload.trace import build_trace

N_REQ = 120
RTOL = 1e-5   # f32 sums in another order than XLA's


def _genomes(n=32, seed=0):
    rng = np.random.default_rng(seed)
    g = BOUNDS_LO + rng.random((n, 6)).astype(np.float32) * (BOUNDS_HI
                                                             - BOUNDS_LO)
    g[0] = PAPER_DEFAULTS
    g[1, :3] = 1.0          # everything goes to the edge
    g[1, 3] = 0.0           # ... unless a queue is busy
    return g.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _evaluators(mode, conc):
    ev = TraceEvaluator(build_trace(N_REQ, seed=1), paper_testbed(),
                        EvalConfig(concurrency=conc, mode=mode),
                        device="cpu")
    ref = RefEvaluator(ref_build_trace(N_REQ, seed=1), ref_testbed(),
                       RefEvalConfig(concurrency=conc, mode=mode))
    return ev, ref


def _ref_population(ref, policy, genomes):
    return jax.vmap(lambda g: ref.run_policy(policy, g))(jnp.asarray(genomes))


def _check_result(got, want):
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    for f in ("q", "cost", "rt", "ttft", "tpot"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.violation.numpy(),
                               np.asarray(want.violation), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("mode,conc", [("eq5", 1), ("eq5", 4),
                                       ("queued", 1), ("queued", 4)])
def test_threshold_population_matches_reference(mode, conc):
    ev, ref = _evaluators(mode, conc)
    G = _genomes()
    F, viol = ev.make_fitness("threshold")(torch.from_numpy(G))
    F_ref, viol_ref = ref.make_fitness("threshold")(jnp.asarray(G),
                                                     jax.random.key(0))
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=RTOL)
    np.testing.assert_allclose(viol.numpy(), np.asarray(viol_ref), rtol=RTOL)
    _check_result(ev.run_population("threshold", G),
                  _ref_population(ref, "threshold", G))


def test_direct_population_matches_reference():
    ev, ref = _evaluators("queued", 4)
    rng = np.random.default_rng(3)
    A = rng.integers(0, 10, (16, N_REQ)).astype(np.int32)
    _check_result(ev.run_population("direct", A),
                  _ref_population(ref, "direct", A))
    F, _ = ev.make_fitness("direct")(torch.from_numpy(A))
    F_ref, _ = ref.make_fitness("direct")(jnp.asarray(A), jax.random.key(0))
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=RTOL)


def test_single_runs_and_summaries_match_reference():
    ev, ref = _evaluators("queued", 4)
    got = ev.run_thresholds(PAPER_DEFAULTS)
    want = ref.run_thresholds(jnp.asarray(PAPER_DEFAULTS))
    _check_result(got, want)
    s, s_ref = ev.summarize(got), ref.summarize(want)
    for k, v in s.items():
        np.testing.assert_allclose(v, s_ref[k], rtol=RTOL, atol=1e-9,
                                   err_msg=k)
    pq, pq_ref = ev.per_dataset_quality(got), ref.per_dataset_quality(want)
    assert pq.keys() == pq_ref.keys()
    for k in pq:
        np.testing.assert_allclose(pq[k], pq_ref[k], rtol=RTOL)
    agg = aggregate(got.q, got.cost, got.rt).stack().numpy()
    np.testing.assert_allclose(agg, [s["RQ"], s["avg_cost"],
                                     s["avg_response_time"]], rtol=RTOL)


@pytest.mark.parametrize("seed", range(4))
def test_threshold_decision_twins_agree(seed):
    """decide_pair_torch (batched) == decide_pair_py == the jnp reference."""
    rng = np.random.default_rng(seed)
    arrays = paper_testbed().to_arrays("cpu")
    ref_arrays = ref_testbed().to_arrays()
    G = _genomes(24, seed)
    for _ in range(8):
        cx = np.float32(rng.random())
        cat = np.int32(rng.integers(0, 3))
        conf = np.float32(rng.random())
        queue = rng.integers(0, 6, (24, 4)).astype(np.int32)
        got = decide_pair_torch(
            torch.from_numpy(G), complexity=torch.tensor(cx),
            pred_category=torch.tensor(cat), pred_conf=torch.tensor(conf),
            queue_len=torch.from_numpy(queue), arrays=arrays).numpy()
        for p in range(24):
            py = decide_pair_py(G[p], complexity=float(cx),
                                pred_category=int(cat),
                                pred_conf=float(conf), queue_len=queue[p],
                                arrays=arrays)
            jx = int(decide_pair_jnp(jnp.asarray(G[p]), complexity=cx,
                                     pred_category=cat, pred_conf=conf,
                                     queue_len=jnp.asarray(queue[p]),
                                     arrays=ref_arrays))
            assert got[p] == py == jx


def test_registry_and_unported_modes():
    assert list_policies() == ("direct", "threshold")
    with pytest.raises(ValueError, match="registered policies"):
        get_policy("slo")
    for kw in (dict(mode="open"), dict(prefix_cache=True),
               dict(disaggregated=True), dict(faulty=True),
               dict(learned=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            EvalConfig(**kw)
    ev, _ = _evaluators("eq5", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ev.make_fitness("threshold", objectives="qoe")


def test_objectives_match_reference():
    rng = np.random.default_rng(5)
    q, cost, rt, ttft, tpot = (rng.random(50).astype(np.float32)
                               for _ in range(5))
    ttft_dl, tpot_dl = (np.full(50, 0.5, np.float32) for _ in range(2))
    t = [torch.from_numpy(a) for a in (q, cost, rt, ttft, tpot, ttft_dl,
                                       tpot_dl)]
    j = [jnp.asarray(a) for a in (q, cost, rt, ttft, tpot, ttft_dl, tpot_dl)]
    np.testing.assert_allclose(aggregate_qoe(*t).stack().numpy(),
                               np.asarray(ref_obj.aggregate_qoe(*j).stack()),
                               rtol=1e-6)
    np.testing.assert_array_equal(slo_ok(*t[3:]).numpy(),
                                  np.asarray(ref_obj.slo_ok(*j[3:])))
    np.testing.assert_allclose(float(slo_attainment(*t[3:])),
                               float(ref_obj.slo_attainment(*j[3:])))
    args = ([0.2, 0.3, 0.5], [0.0, 0.0, 0.0], [1.0, 1.0, 2.0])
    np.testing.assert_allclose(
        float(weighted_scalar(aggregate(*t[:3]), *args)),
        float(ref_obj.weighted_scalar(ref_obj.aggregate(*j[:3]), *args)),
        rtol=1e-6)
    qa, ta, ca = np.array([0.5, 0.6]), np.array([2.0, 1.0]), np.array([1, 3.])
    np.testing.assert_array_equal(overall_scores(qa, ta, ca),
                                  ref_obj.overall_scores(qa, ta, ca))
