"""The port's copy of the discrete-event simulator against the reference's:
``ClusterSimulator.run`` and ``run_event_heap`` give bit-equal ``SimResult``s
on the same traces (each package builds its own from the same seed; the
traces' equality is held in ``test_torch_data.py`` and
``test_torch_sessions.py``) in every mode the reference's tests drive: closed
loop at concurrency 1 and 10, open loop, a node down, the prefix cache with
in-loop policy decisions, disaggregated routes, fault injection and the
learned estimators (EWMA and BLR, carried across windows). The copy also
agrees with the port's own evaluator as the reference's DES agrees with
its scan (assignments exact, times within 1e-4), and the online-learning
twin's rows equal the reference benchmark's."""
import dataclasses

import numpy as np
import pytest

import benchmarks.online_learning as ref_ol
from repro import faults as rf
from repro.cluster.simulator import ClusterSimulator as RefSim
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import baselines as ref_baselines
from repro.learn import LearnConfig as RefLearnConfig
from repro.workload.arrivals import PhaseSpec as RefPhase
from repro.workload.arrivals import build_open_loop_trace as ref_open
from repro.workload.sessions import SessionConfig as RefSessionConfig
from repro.workload.sessions import build_session_trace as ref_sessions
from repro.workload.slo import attach_slos as ref_attach
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch import faults as tf
from repro_torch import online_learning
from repro_torch.cluster.simulator import ClusterSimulator, SimResult
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core import baselines
from repro_torch.core.fitness import EvalConfig, TraceEvaluator
from repro_torch.core.policies import get_policy, list_policies
from repro_torch.learn import LearnConfig
from repro_torch.workload.arrivals import PhaseSpec, build_open_loop_trace
from repro_torch.workload.sessions import SessionConfig, build_session_trace
from repro_torch.workload.slo import attach_slos
from repro_torch.workload.trace import build_trace

CLUSTER, REF_CLUSTER = paper_testbed(), ref_testbed()


def _chaos(mod, n_nodes=4):
    """tests/test_faults.py's mixed regime, built in either package."""
    return mod.FaultSchedule(
        crashes=(mod.CrashWindow(1, 1.0, 12.0), mod.CrashWindow(0, 20.0, 26.0)),
        stragglers=(mod.Straggler(2 % n_nodes, 4.0, 30.0, 3.0),),
        link_flaps=(mod.LinkFlap(2.0, 18.0, 15.0),),
        transient=mod.TransientErrors(rate=0.15, backoff=0.08, seed=11))


def _stragglers(mod):
    return mod.FaultSchedule(stragglers=(mod.Straggler(1, 0.0, 1e9, 3.0),
                                         mod.Straggler(2, 5.0, 60.0, 2.0)))


def _sessions(n=70, seed=7):
    """(port, reference) session traces with SLOs, as conftest builds."""
    tr = build_session_trace(SessionConfig(n_sessions=10, mean_turns=3.0),
                             seed=seed, n_requests=n)
    attach_slos(tr, tightness=2.0, seed=seed)
    rt = ref_sessions(RefSessionConfig(n_sessions=10, mean_turns=3.0),
                      seed=seed, n_requests=n)
    ref_attach(rt, tightness=2.0, seed=seed)
    return tr, rt


def _equal(got: SimResult, want):
    for f in dataclasses.fields(SimResult):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name


def _both(sim, ref, **kw):
    _equal(sim.run(**kw), ref.run(**kw))
    _equal(sim.run_event_heap(**kw), ref.run_event_heap(**kw))


@pytest.mark.parametrize("concurrency", [1, 10])
def test_closed_loop_bit_equal(concurrency):
    tr, rt = build_trace(120, seed=0), ref_build_trace(120, seed=0)
    for name in ("random_router", "round_robin", "edge_only", "cloud_only"):
        assign = getattr(baselines, name)(tr, CLUSTER)
        np.testing.assert_array_equal(
            assign, getattr(ref_baselines, name)(rt, REF_CLUSTER))
        _both(ClusterSimulator(tr, CLUSTER), RefSim(rt, REF_CLUSTER),
              assign=assign, concurrency=concurrency)


def test_node_down_and_open_loop_bit_equal():
    tr, rt = build_trace(80, seed=3), ref_build_trace(80, seed=3)
    assign = baselines.edge_only(tr, CLUSTER)
    sim, ref = ClusterSimulator(tr, CLUSTER), RefSim(rt, REF_CLUSTER)
    down = {1: (0.0, float("inf")), 2: (3.0, 9.0)}
    _equal(sim.run(assign, concurrency=1, down_nodes=down),
           ref.run(assign, concurrency=1, down_nodes=down))
    arr = np.sort(np.random.default_rng(1).uniform(0, 30, 80))
    _both(sim, ref, assign=assign, arrivals=arr)
    ph = (PhaseSpec(rate=2.0, duration=1e9, mix=(0.1, 0.7, 0.1, 0.1)),)
    ot = build_open_loop_trace(60, ph, seed=4)
    ort = ref_open(60, (RefPhase(rate=2.0, duration=1e9,
                                 mix=(0.1, 0.7, 0.1, 0.1)),), seed=4)
    a = baselines.random_router(ot, CLUSTER, seed=2)
    _both(ClusterSimulator(ot, CLUSTER), RefSim(ort, REF_CLUSTER), assign=a)


@pytest.mark.parametrize("policy", list_policies())
def test_policies_prefix_cache_and_faults_bit_equal(policy):
    """In-loop decisions through the registry, on the session trace with
    the prefix cache, clean and under the chaos schedule; disaggregated
    routes for ``disagg``."""
    tr, rt = _sessions()
    pol = get_policy(policy)
    genome = (np.random.default_rng(0).integers(
        0, CLUSTER.n_pairs, tr.n_requests).astype(np.int32)
        if pol.genome_spec.per_request else pol.genome_spec.defaults)
    disagg = pol.decides == "route"
    for faults in ((None, None), (_chaos(tf), _chaos(rf))):
        sim = ClusterSimulator(tr, CLUSTER, prefix_cache=True,
                               disaggregated=disagg, faults=faults[0])
        ref = RefSim(rt, REF_CLUSTER, prefix_cache=True,
                     disaggregated=disagg, faults=faults[1])
        _both(sim, ref, policy=policy, genome=genome)


@pytest.mark.parametrize("kind", ["ewma", "blr"])
def test_learned_estimators_bit_equal_across_windows(kind):
    """Learned estimators under stragglers, the state carried from one
    window into the next (``run(learn_state=)``)."""
    tr, rt = _sessions(60, 7)
    policy = "bandit" if kind == "blr" else "slo"
    genome = get_policy(policy).genome_spec.defaults
    sim = ClusterSimulator(tr, CLUSTER, prefix_cache=True,
                           faults=_stragglers(tf), learned=True,
                           learner=LearnConfig(kind=kind))
    ref = RefSim(rt, REF_CLUSTER, prefix_cache=True, faults=_stragglers(rf),
                 learned=True, learner=RefLearnConfig(kind=kind))
    a, b = sim.run(policy=policy, genome=genome), ref.run(policy=policy,
                                                          genome=genome)
    _equal(a, b)
    _both(sim, ref, policy=policy, genome=genome,
          learn_state=a.learn_state)


@pytest.mark.parametrize("policy", ["slo", "affinity", "disagg"])
def test_simulator_agrees_with_the_port_evaluator(policy):
    """The DES copy against the port's evaluator (on the CPU), as the
    reference's DES is held against its scan: the same assignments, the
    realized metrics within 1e-4 relative (1e-5 absolute), with the cache,
    faults and the learned estimators on."""
    tr, _ = _sessions()
    pol = get_policy(policy)
    genome = pol.genome_spec.defaults
    disagg = pol.decides == "route"
    ev = TraceEvaluator(tr, CLUSTER, EvalConfig(
        mode="open", prefix_cache=True, disaggregated=disagg, learned=True,
        faulty=True), faults=_stragglers(tf), device="cpu")
    res = ev.run_policy(policy, genome)
    sim = ClusterSimulator(tr, CLUSTER, prefix_cache=True,
                           disaggregated=disagg, faults=_stragglers(tf),
                           learned=True)
    for sr in (sim.run(policy=policy, genome=genome),
               sim.run_event_heap(policy=policy, genome=genome)):
        np.testing.assert_array_equal(res.assign.numpy(), sr.assign)
        for f in ("q", "cost", "rt", "ttft", "tpot", "hit"):
            np.testing.assert_allclose(getattr(res, f).numpy(),
                                       getattr(sr, f), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{policy}:{f}")


def test_online_learning_rows_equal_the_reference():
    """Every (policy, variant) row of the twin equals the reference
    benchmark's ``run_variant`` at its full size (4 windows of 60), and the
    composites and verdicts follow."""
    assert online_learning.sizes(False) == (ref_ol.WINDOW_REQUESTS,
                                            ref_ol.N_WINDOWS)
    rows, verdicts = online_learning.run(seed=0)
    want = []
    for policy, kind in ref_ol.VARIANTS:
        per = {}
        for learned in (False, True):
            per[learned] = ref_ol.run_variant(policy, learned, kind, seed=0)
            for k, r in enumerate(per[learned]):
                want.append([policy, "learned" if learned else "static",
                             kind if learned else "-", k,
                             f"{r[0]:.4f}", f"{r[1]:.4e}", f"{r[2]:.4f}",
                             f"{r[3]:.4f}", f"{r[4]:.4f}", f"{r[5]:.4f}"])
            got = online_learning.run_variant(policy, learned, kind)
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(per[learned]))
        c = ref_ol._composite(ref_ol._post_drift_mean(per[False]),
                              ref_ol._post_drift_mean(per[True]))
        assert (verdicts[policy]["composite_static"],
                verdicts[policy]["composite_learned"]) == c
    assert rows == want
