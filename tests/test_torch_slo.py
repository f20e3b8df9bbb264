"""Parity of the port's QoE/SLO slice with the JAX package's: the copied
deadline module attaches the same deadlines bit for bit, the ``slo``
policy's batched decision equals the reference's jnp decision and its numpy
oracle on every seeded input, the SLO policy and the 4-objective QoE fitness
give the reference evaluator's assignments exactly and its rows and
objectives within f32 summation-order tolerance, and the router's ``slo``
mode routes as the reference router does."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core.fitness import EvalConfig as RefEvalConfig
from repro.core.fitness import TraceEvaluator as RefEvaluator
from repro.core.fitness import \
    request_pair_estimates as ref_request_pair_estimates
from repro.core.policies.slo import decide_pair_slo_jnp
from repro.core.router import RequestRouter as RefRouter
from repro.workload import slo as ref_slo
from repro.workload.arrivals import build_open_loop_trace as ref_open_trace
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch.cluster.spec import ClusterArrays, paper_testbed
from repro_torch.core.fitness import (EvalConfig, TraceEvaluator,
                                      request_pair_estimates)
from repro_torch.core.policies import get_policy
from repro_torch.core.policies.slo import (SLO_BOUNDS_HI, SLO_BOUNDS_LO,
                                           SLO_DEFAULTS, decide_pair_slo_py,
                                           decide_pair_slo_torch)
from repro_torch.core.policies.threshold import PAPER_DEFAULTS
from repro_torch.core.router import RequestRouter
from repro_torch.workload import slo
from repro_torch.workload.arrivals import PhaseSpec, build_open_loop_trace
from repro_torch.workload.trace import build_trace

RTOL = 1e-5   # f32 sums in another order than XLA's
STORM = (PhaseSpec(rate=8.0, duration=1e9, mix=(0.1, 0.6, 0.2, 0.1),
                   length_scale=1.5),)


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tightness,frac,seed", [(1.0, 0.5, 0), (0.4, 0.9, 3),
                                                 (2.5, 0.1, 7), (0.0, 0.5, 1)])
def test_attach_slos_and_slo_arrays_bit_equal(tightness, frac, seed):
    for got, want in zip(slo.slo_arrays(), ref_slo.slo_arrays()):
        _bit_equal(got, want)
    assert slo.DEFAULT_SLO_TABLE == {
        k: slo.CategorySLO(v.ttft_s, v.tpot_s)
        for k, v in ref_slo.DEFAULT_SLO_TABLE.items()}
    assert (slo.INTERACTIVE_SCALE, slo.BATCH_SCALE) == (
        ref_slo.INTERACTIVE_SCALE, ref_slo.BATCH_SCALE)
    got = slo.attach_slos(build_trace(80, seed=seed), tightness=tightness,
                          interactive_frac=frac, seed=seed)
    want = ref_slo.attach_slos(ref_build_trace(80, seed=seed),
                               tightness=tightness, interactive_frac=frac,
                               seed=seed)
    assert got.has_slos and want.has_slos
    for f in ("ttft_deadline", "tpot_deadline", "slo_interactive"):
        _bit_equal(getattr(got, f), getattr(want, f))


def test_trace_without_slos_has_inf_deadlines_and_no_attainment():
    tr = build_trace(20, seed=0)
    assert not tr.has_slos
    ev = TraceEvaluator(tr, paper_testbed(), device="cpu")
    assert torch.isinf(ev.tables.ttft_deadline).all()
    assert torch.isinf(ev.tables.tpot_deadline).all()
    assert "slo_attainment" not in ev.summarize(
        ev.run_assignment(np.zeros(20, np.int32)))
    with pytest.raises(AssertionError, match="SLOs"):
        ev.make_fitness("threshold", objectives="qoe")


def test_request_pair_estimates_bit_equal():
    arrays = ClusterArrays(**paper_testbed().arrays_numpy())
    ref_arrays = ref_testbed().to_arrays()
    rng = np.random.default_rng(0)
    for _ in range(20):
        args = (float(rng.integers(1, 900)), float(rng.uniform(1, 400)),
                float(rng.integers(10, 9000)))
        got = request_pair_estimates(*args, arrays)
        want = ref_request_pair_estimates(*args, ref_arrays)
        assert got.keys() == want.keys()
        for k in got:
            _bit_equal(got[k], want[k])


def _slo_inputs(seed, P=32):
    """One request's estimate rows and deadlines, and a (P, n_nodes) queue
    view with a genome per row: relaxed, tight, infeasible, infinite and
    near-tie deadlines (a deadline equal to a pair's own estimate)."""
    rng = np.random.default_rng(seed)
    arrays = ClusterArrays(**paper_testbed().arrays_numpy())
    est = request_pair_estimates(float(rng.integers(20, 900)),
                                 float(rng.integers(10, 300)),
                                 float(rng.integers(100, 4000)), arrays)
    G = SLO_BOUNDS_LO + rng.random((P, 2)).astype(np.float32) * (
        SLO_BOUNDS_HI - SLO_BOUNDS_LO)
    G[0] = SLO_DEFAULTS
    G[1] = [1.0, 0.0]           # no headroom, no wait: ties land on est_ttft
    G = G.astype(np.float32)
    queue = rng.integers(0, 12, (P, arrays.n_nodes)).astype(np.int32)
    kind = seed % 5
    if kind == 0:
        ttft, tpot = rng.uniform(0.05, 6.0), rng.uniform(0.03, 0.8)
    elif kind == 1:
        ttft, tpot = 5.0, 0.8
    elif kind == 2:
        ttft, tpot = 1e-4, 1e-4
    elif kind == 3:
        ttft, tpot = np.inf, np.inf
    else:                       # a pair's own estimate at zero load
        p = int(rng.integers(0, arrays.n_pairs))
        ttft = float(est["up"][p] + est["prefill"][p])
        tpot = float(est["tpot"][p])
    return (G, np.float32(ttft), np.float32(tpot), est, queue, arrays)


@functools.lru_cache(maxsize=None)
def _jnp_decide():
    ref_arrays = ref_testbed().to_arrays()

    def one(g, ttft, tpot, up, prefill, tp, cost, queue):
        return decide_pair_slo_jnp(g, ttft_deadline=ttft, tpot_deadline=tpot,
                                   up=up, prefill=prefill, tpot=tp, cost=cost,
                                   queue_len=queue, arrays=ref_arrays)

    return jax.jit(jax.vmap(one, in_axes=(0, None, None, None, None, None,
                                          None, 0)))


@pytest.mark.parametrize("block", range(4))
def test_slo_decision_twins_agree(block):
    """decide_pair_slo_torch (batched) == the reference's jnp decision ==
    decide_pair_slo_py, over 4 x 5 requests x 32 genomes = 640 inputs."""
    n = 0
    for seed in range(5 * block, 5 * block + 5):
        G, ttft, tpot, est, queue, arrays = _slo_inputs(seed)
        t = {k: torch.from_numpy(v) for k, v in est.items()}
        got = decide_pair_slo_torch(
            torch.from_numpy(G), ttft_deadline=torch.tensor(ttft),
            tpot_deadline=torch.tensor(tpot), up=t["up"],
            prefill=t["prefill"], tpot=t["tpot"], cost=t["cost"],
            queue_len=torch.from_numpy(queue),
            arrays=paper_testbed().to_arrays("cpu")).numpy()
        jx = np.asarray(_jnp_decide()(
            jnp.asarray(G), jnp.float32(ttft), jnp.float32(tpot),
            jnp.asarray(est["up"]), jnp.asarray(est["prefill"]),
            jnp.asarray(est["tpot"]), jnp.asarray(est["cost"]),
            jnp.asarray(queue)))
        for p in range(G.shape[0]):
            py = decide_pair_slo_py(G[p], ttft_deadline=float(ttft),
                                    tpot_deadline=float(tpot), up=est["up"],
                                    prefill=est["prefill"], tpot=est["tpot"],
                                    cost=est["cost"], queue_len=queue[p],
                                    arrays=arrays)
            assert got[p] == jx[p] == py, (seed, p, got[p], jx[p], py)
            n += 1
    assert n == 160


@functools.lru_cache(maxsize=None)
def _open_evaluators(n, seed):
    tr = slo.attach_slos(build_open_loop_trace(n, STORM, seed=seed),
                         tightness=1.0, seed=seed)
    ref_tr = ref_slo.attach_slos(ref_open_trace(n, STORM, seed=seed),
                                 tightness=1.0, seed=seed)
    return (TraceEvaluator(tr, paper_testbed(), EvalConfig(mode="open"),
                           device="cpu"),
            RefEvaluator(ref_tr, ref_testbed(), RefEvalConfig(mode="open")))


def _slo_genomes(n=24, seed=0):
    rng = np.random.default_rng(seed)
    G = SLO_BOUNDS_LO + rng.random((n, 2)).astype(np.float32) * (
        SLO_BOUNDS_HI - SLO_BOUNDS_LO)
    G[0] = SLO_DEFAULTS
    return G.astype(np.float32)


def test_slo_policy_and_qoe_fitness_match_reference():
    ev, ref = _open_evaluators(90, 2)
    G = _slo_genomes()
    got = ev.run_population("slo", G)
    want = jax.vmap(lambda g: ref.run_policy("slo", g))(jnp.asarray(G))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    for f in ("q", "cost", "rt", "ttft", "tpot"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL,
                                   atol=1e-6, err_msg=f)
    F, viol = ev.make_fitness("slo", objectives="qoe")(torch.from_numpy(G))
    F_ref, viol_ref = ref.make_fitness("slo", objectives="qoe")(
        jnp.asarray(G), jax.random.key(0))
    assert F.shape == (24, 4)
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=RTOL)
    np.testing.assert_allclose(viol.numpy(), np.asarray(viol_ref), rtol=RTOL,
                               atol=1e-6)
    # the single-genome shorthand and the attainment summary
    one, ref_one = ev.run_slo_policy(SLO_DEFAULTS), ref.run_slo_policy(
        jnp.asarray(SLO_DEFAULTS))
    np.testing.assert_array_equal(one.assign.numpy(),
                                  np.asarray(ref_one.assign))
    s, s_ref = ev.summarize(one), ref.summarize(ref_one)
    assert "slo_attainment" in s and "cache_hit_frac" in s
    assert set(s) == set(s_ref)
    for k in s:
        np.testing.assert_allclose(s[k], s_ref[k], rtol=RTOL, atol=1e-9,
                                   err_msg=k)


def test_slo_policy_registry_entry():
    pol = get_policy("slo")
    assert pol.requires == frozenset({"estimates", "deadlines"})
    assert pol.decides == "pair" and pol.genome_spec.length == 2
    from repro.core.policies import get_policy as ref_get_policy
    ref = ref_get_policy("slo").genome_spec
    for f in ("lo", "hi", "defaults"):
        _bit_equal(getattr(pol.genome_spec, f), getattr(ref, f))
    assert pol.genome_spec.names == ref.names


def test_router_slo_mode_splits_by_deadline_class_and_fails_over():
    tr = build_trace(8, seed=3)
    ref_tr = ref_build_trace(8, seed=3)
    for kw in (dict(ttft_deadline=0.6, tpot_deadline=0.08),
               dict(ttft_deadline=5.0, tpot_deadline=0.8)):
        r = RequestRouter(paper_testbed(), PAPER_DEFAULTS, mode="slo",
                          device="cpu")
        ref = RefRouter(ref_testbed(), PAPER_DEFAULTS, mode="slo")
        d, rd = r.route(tr.requests[0], **kw), ref.route(ref_tr.requests[0],
                                                         **kw)
        assert (d.pair, d.go_edge) == (rd.pair, rd.go_edge)
        assert d.go_edge == (kw["tpot_deadline"] > 0.5)
    r = RequestRouter(paper_testbed(), PAPER_DEFAULTS, mode="slo",
                      device="cpu")
    r.monitor.mark_down(0)              # the cloud is down
    d = r.route(tr.requests[0], ttft_deadline=0.6, tpot_deadline=0.08)
    assert d.node != 0
