"""Parity of the port's runtime router with the JAX package's in the modes
this slice brings: ``route()`` for every runtime policy, with and without
the learned estimators, makes the reference router's decisions over a
seeded multi-turn session stream (nodes going down and coming back,
prefixes recorded on the serving nodes, explicit deadlines and clocks);
after each ``record(ttft=, tpot=)`` the monitor's estimator state is
bit-equal to the reference's; the route-valued failover picks what the
reference picks; and a re-fit of ``affinity`` and ``disagg`` with
``learned=True`` run on the reference's random draws installs the
reference router's genome."""
import functools

import numpy as np
import pytest

from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core.router import RequestRouter as RefRouter
from repro.obs.audit import AuditLog
from repro.workload.sessions import SessionConfig as RefSessionConfig
from repro.workload.sessions import build_session_trace as ref_sessions
from repro.workload.slo import attach_slos as ref_attach_slos
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core import nsga2 as tn
from repro_torch.core.policies import runtime_policies
from repro_torch.core.router import RequestRouter
from repro_torch.workload.sessions import SessionConfig, build_session_trace
from repro_torch.workload.slo import attach_slos
from test_torch_online import _replay_evolve_scan

DECISION_FIELDS = ("pair", "node", "model", "go_edge", "features",
                   "backup_pair", "prefill_pair", "est_cost", "est_ttft",
                   "est_tpot", "est_quality")
BLOCK = 16


@functools.lru_cache(maxsize=None)
def _streams(n=96, seed=5):
    def make(cfg_cls, build, attach):
        tr = build(cfg_cls(n_sessions=n // 3, mean_turns=3.0,
                           session_rate=1.5, think_time_s=3.0),
                   seed=seed, n_requests=n)
        return attach(tr, tightness=1.5, seed=seed)
    return (make(SessionConfig, build_session_trace, attach_slos),
            make(RefSessionConfig, ref_sessions, ref_attach_slos))


def _drive(router, trace, learned):
    """Route the stream: the cloud down for a stretch, then edge node 2,
    then both edge nodes 1 and 3; every served prompt's whole-block prefix
    recorded on the node(s) that served it; completions four requests
    later; deadlines on every request but each fourth; ``record`` with
    realized TTFT/TPOT (the cloud serving 3x slow). Returns the decisions
    and the estimator state after each record."""
    mon = router.monitor
    rng = np.random.default_rng(11)
    decisions, states, inflight = [], [], []
    for i, req in enumerate(trace.requests):
        now = float(trace.arrival_time[i])
        if i == 15:
            mon.mark_down(0)
        if i == 35:
            mon.heartbeat(0, now=now)
            mon.mark_down(2)
        if i == 55:
            mon.heartbeat(2, now=now)
            mon.mark_down(1)
            mon.mark_down(3)
        if i == 70:
            mon.heartbeat(1, now=now)
            mon.heartbeat(3, now=now)
        kw = {}
        if i % 4:
            kw = dict(ttft_deadline=float(trace.ttft_deadline[i]),
                      tpot_deadline=float(trace.tpot_deadline[i]))
        d = router.route(req, want_backup=i % 5 == 0, now=now, **kw)
        mon.on_dispatch(d.node)
        legs = {d.node} if d.prefill_pair is None else {
            d.node, int(router.arrays.pair_node[d.prefill_pair])}
        for node in sorted(legs):
            if req.session_id >= 0:
                mon.record_prefix(node, ("sess", req.session_id),
                                  req.prompt_tokens // BLOCK * BLOCK)
            if req.sys_id >= 0:
                mon.record_prefix(node, ("sys", req.sys_id),
                                  req.sys_tokens // BLOCK * BLOCK)
        inflight.append(d.node)
        if len(inflight) > 4:
            mon.on_complete(inflight.pop(0), 1.0 + (i % 7) * 0.1)
        slow = 3.0 if d.node == 0 else 1.0
        router.record(req, d, quality=float(rng.uniform(0.2, 0.9)),
                      cost=d.est_cost, rt=1.0, now=now,
                      ttft_deadline=float(trace.ttft_deadline[i]),
                      tpot_deadline=float(trace.tpot_deadline[i]),
                      ttft=d.est_ttft * slow * float(rng.uniform(0.8, 1.2))
                      if learned else None,
                      tpot=d.est_tpot * slow if learned else None)
        decisions.append(d)
        est = mon.estimator
        states.append(None if est is None else est.state.copy())
    return decisions, states


def _routers(mode, learned, params=None):
    kw = dict(mode=mode, learned=learned, params=params)
    return (RequestRouter(paper_testbed(), device="cpu", **kw),
            RefRouter(ref_testbed(), audit=AuditLog(), **kw))


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("mode", runtime_policies())
def test_route_matches_reference_router(mode, learned):
    tr, ref_tr = _streams()
    r, ref = _routers(mode, learned)
    got, states = _drive(r, tr, learned)
    want, ref_states = _drive(ref, ref_tr, learned)
    for i, (d, w) in enumerate(zip(got, want)):
        for f in DECISION_FIELDS:
            assert getattr(d, f) == getattr(w, f), (i, f)
        if learned:
            assert states[i].tobytes() == ref_states[i].tobytes(), i
        assert d.node != 0 or not 15 <= i < 35    # never onto a dead node
    assert r.monitor.estimator is not None if learned else \
        r.monitor.estimator is None
    if learned:
        assert r.monitor.estimator.n_obs == ref.monitor.estimator.n_obs == 96
        assert not np.array_equal(states[-1], states[0])
    for j in range(4):
        assert r.monitor.stats[j].cached_prefixes == \
            ref.monitor.stats[j].cached_prefixes
    assert r._pstate.tobytes() == np.asarray(ref._pstate).tobytes()
    if mode == "threshold":     # its cloud fallback was down: failed over
        assert ref.audit.failovers()


@pytest.mark.parametrize("learned", [False, True])
def test_route_valued_failover_matches_reference(learned):
    """τ = 0 prices the decode leg's queue at nothing, so the policy picks
    split routes whose decode node is down; both routers fail over to the
    same healthy colocated route."""
    tr, ref_tr = _streams()
    genome = np.array([0.9, 3.0, 0.0], np.float32)
    r, ref = _routers("disagg", learned, genome)
    got, _ = _drive(r, tr, learned)
    want, _ = _drive(ref, ref_tr, learned)
    for i, (d, w) in enumerate(zip(got, want)):
        for f in DECISION_FIELDS:
            assert getattr(d, f) == getattr(w, f), (i, f)
    fails = [a for a in ref.audit.failovers()
             if a.failover == "route-endpoint-down"]
    assert fails
    for a in fails:
        d = got[a.index]
        assert d.prefill_pair == d.pair     # colocated while degraded


@pytest.mark.parametrize("mode", ["affinity", "disagg"])
def test_learned_refit_on_reference_draws_installs_reference_genome(
        mode, monkeypatch):
    """Two re-fits in a row (the second warm-started from the first's
    archive) over the recorded session window, padded from 96 to 128 rows:
    open loop, the prefix cache on, the route table for ``disagg``, the
    learned estimators, QoE objectives. The port's genome and archive
    equal the reference router's."""
    monkeypatch.setattr(tn.NSGA2, "evolve_scan", _replay_evolve_scan)
    tr, ref_tr = _streams()
    r, ref = _routers(mode, True)
    _drive(r, tr, True)
    _drive(ref, ref_tr, True)
    kw = dict(force=True, window=96, generations=3, pop_size=8)
    for seed in (0, 1):
        got = r.maybe_reoptimize(seed=seed, **kw)
        want = ref.maybe_reoptimize(seed=seed, **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(r._archive, np.asarray(ref._archive),
                                   rtol=1e-6)
    trace = r.window_trace(96)
    assert trace.has_arrivals and trace.has_sessions and trace.has_slos
