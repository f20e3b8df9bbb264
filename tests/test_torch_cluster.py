"""The port's ``ClusterServer`` and serving launcher against the reference's,
on the CPU with the same f32 weights.

Every scenario runs the same script on both packages: the served results
(tokens, QoE records, tick latencies), ``stats()`` and what the script
returns must be equal, and the reference test's own assertions must hold
on the port. Twins of ``tests/test_serving.py``'s cluster tests (serving,
failover, hedging and its drain, affinity prefix reuse, ``recover_node``
on the tick clock), ``tests/test_disagg.py``'s (handoffs, prefill- and
decode-node death mid-transfer) and ``tests/test_faults.py``'s serving
chaos tests (heartbeat loss, slow credit, transient retries, timeouts,
shedding, conservation under every runtime policy, phase-B exceptions);
then the launcher's ``--smoke --device cpu`` path, with and without
``--optimize-router``, against the reference launcher's pieces.
"""
import dataclasses
import functools
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as rfaults
from repro.cluster.spec import disagg_testbed as ref_disagg_testbed
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.configs import get as ref_get
from repro.core.fitness import EvalConfig as RefEvalConfig
from repro.core.fitness import TraceEvaluator as RefEvaluator
from repro.core.nsga2 import NSGA2 as RefNSGA2
from repro.core.nsga2 import NSGA2Config as RefNSGA2Config
from repro.core.policies import runtime_policies
from repro.core.policy import BOUNDS_HI, BOUNDS_LO, PAPER_DEFAULTS
from repro.models import lm as rlm
from repro.serving import ClusterServer as RefServer
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import ResilienceConfig as RefResilienceConfig
from repro.serving import ServeRequest as RefServeRequest
from repro.workload.sessions import SessionConfig as RefSessionConfig
from repro.workload.sessions import build_session_trace as ref_sessions
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch import faults
from repro_torch.cluster.spec import disagg_testbed, paper_testbed
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import decode_attention, dominance, flash_attention
from repro_torch.launch import serve as launch
from repro_torch.serving import (ClusterServer, EngineConfig,
                                 ResilienceConfig, ServeRequest)
from repro_torch.serving.scheduler import tokenize
from repro_torch.workload.sessions import SessionConfig, build_session_trace
from repro_torch.workload.trace import build_trace

NO_HEDGE = 10 ** 9
EDGE_NAMES = launch.EDGE_NAMES
ECFG = dict(max_slots=2, max_seq=48, max_new_tokens=4)
PAGED = dict(prefix_cache=True, block_size=8, cache_blocks=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops; with several test processes on the
    machine, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(name: str, seed: int):
    rcfg = dataclasses.replace(ref_get(name).smoke(), dtype="float32")
    cfg = dataclasses.replace(get(name).smoke(), dtype="float32")
    params = rlm.init(jax.random.key(seed), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return (rcfg, params), (cfg, model)


def _builders(side: int, single=False):
    """The launcher's model map on one side (0 reference, 1 port): the
    smoke stablelm-3b (seed 0) for the cloud name, one smoke qwen3-1.7b
    (seed 1) for the three edge names; ``single``: the disaggregated
    testbed's one name."""
    big = _models("stablelm-3b", 0)[side]
    if single:
        return {"gemma3:27b": big}
    small = _models("qwen3-1.7b", 1)[side]
    return {"gemma3:27b": big, **{n: small for n in EDGE_NAMES}}


@functools.lru_cache(maxsize=None)
def _sides():
    """What a scenario script sees of each package."""
    ref = types.SimpleNamespace(
        side=0, Server=RefServer, EC=RefEngineConfig, SR=RefServeRequest,
        Res=RefResilienceConfig, F=rfaults, testbed=ref_testbed,
        disagg_testbed=ref_disagg_testbed, build_trace=ref_build_trace,
        sessions=(ref_sessions, RefSessionConfig), extra={})
    port = types.SimpleNamespace(
        side=1, Server=ClusterServer, EC=EngineConfig, SR=ServeRequest,
        Res=ResilienceConfig, F=faults, testbed=paper_testbed,
        disagg_testbed=disagg_testbed, build_trace=build_trace,
        sessions=(build_session_trace, SessionConfig),
        extra={"device": "cpu"})
    return ref, port


def _server(s, ecfg=ECFG, single=False, policy="threshold", **kw):
    return s.Server(s.disagg_testbed() if single else s.testbed(),
                    _builders(s.side, single), PAPER_DEFAULTS,
                    s.EC(**ecfg), router_kwargs={"mode": policy}, **kw,
                    **s.extra)


def _reqs(s, n, long=False):
    reqs = s.build_trace(24, seed=5).requests[:n]
    if long:   # every prompt spans >= 2 whole KV blocks
        reqs = [dataclasses.replace(r, text=" ".join(f"w{i}_{j}"
                                                     for j in range(20)),
                                    prompt_tokens=20)
                for i, r in enumerate(reqs)]
    return reqs


def _submit(s, srv, reqs, max_new, **kw):
    for i, r in enumerate(reqs):
        srv.submit(s.SR(request_id=i, req=r, max_new_tokens=max_new, **kw))


def _compare(script):
    """``script(side) -> (server, anything)`` on both packages: equal
    ``done``, ``stats()`` and returns. Returns the port's pair."""
    ref, port = _sides()
    r_srv, r_out = script(ref)
    p_srv, p_out = script(port)
    assert p_srv.done == r_srv.done
    assert p_srv.stats() == r_srv.stats()
    assert p_out == r_out
    return p_srv, p_out


def _assert_conserved(srv):
    for node, s in srv.monitor.stats.items():
        assert s.total_dispatched == (s.total_completed + s.total_failed
                                      + s.total_cancelled), (node, s)
        assert s.outstanding == 0, (node, s)


def _active_blocks(eng):
    return int(np.sum(eng.kv.cache.pool.ref > 0))


def _assert_no_leaks(srv):
    for eng in srv.engines.values():
        if eng.kv is not None:
            eng.kv.cache.check_invariants()
            assert _active_blocks(eng) == 0


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors take the plain versions: no kernel launches."""
    before = (dominance.LAUNCHES, flash_attention.LAUNCHES,
              decode_attention.LAUNCHES)
    yield
    assert (dominance.LAUNCHES, flash_attention.LAUNCHES,
            decode_attention.LAUNCHES) == before


# ---------------------------------------------------------------------------
# serving (tests/test_serving.py)
# ---------------------------------------------------------------------------
def test_cluster_server_serves_all():
    def script(s):
        srv = _server(s, dict(ECFG, max_new_tokens=3))
        _submit(s, srv, _reqs(s, 12), 3)
        return srv, srv.run()
    _, done = _compare(script)
    assert sorted(done) == list(range(12))
    assert all(len(d["tokens"]) == 3 for d in done.values())


def test_cluster_server_failover_requeues():
    def script(s):
        srv = _server(s)
        _submit(s, srv, _reqs(s, 8), 4)
        for node in (1, 2, 3):   # every edge node: finish on the cloud
            srv.fail_node(node)
        return srv, srv.run()
    srv, done = _compare(script)
    assert sorted(done) == list(range(8))
    assert srv.stats()["reroutes"] >= 1


@pytest.mark.parametrize("fleet", [False, True])
def test_hedging_and_its_accounting_drain_to_zero(fleet):
    """Aggressive hedging: losers are cancelled, their dispatches closed,
    queue lengths drain to zero (fleet mode's cancel lands an iteration
    later, as in the reference)."""
    def script(s):
        srv = _server(s, dict(ECFG, max_slots=1, max_new_tokens=3),
                      hedge_after=1, fleet=fleet)
        _submit(s, srv, _reqs(s, 8), 3)
        return srv, srv.run()
    srv, done = _compare(script)
    stats = srv.stats()
    assert len(done) == 8 and stats["hedges"] >= 1
    assert stats["cancelled"] >= 1
    assert all(q == 0 for q in stats["queue_lengths"]), stats
    _assert_conserved(srv)


def test_affinity_prefix_reuse_end_to_end():
    """Session traffic through the affinity router into prefix-cached
    engines gives real cache hits; a crashed node restarts with empty
    caches, in the monitor's view and in its engines' pools."""
    def script(s):
        build, SC = s.sessions
        tr = build(SC(n_sessions=4, mean_turns=3.0), seed=2)
        srv = _server(s, dict(ECFG, max_new_tokens=2, **PAGED),
                      policy="affinity")
        reqs = tr.requests[:10]
        _submit(s, srv, reqs, 2)
        done = srv.run()
        stats = [e.cache_stats() for e in srv.engines.values()]
        node = next(n for n, ns in srv.monitor.stats.items()
                    if ns.cached_prefixes)
        srv.fail_node(node)
        return srv, (done, stats, node, len(reqs))
    srv, (done, stats, node, n) = _compare(script)
    assert sorted(done) == list(range(n))
    assert sum(s["hits"] for s in stats) >= 1
    assert (sum(s["prefill_tokens_run"] for s in stats)
            < sum(s["prefill_tokens_total"] for s in stats))
    assert not srv.monitor.stats[node].cached_prefixes
    for p, eng in srv.engines.items():
        if int(srv.router.arrays.pair_node[p]) == node:
            assert eng.kv.cache.pool.n_free == eng.ecfg.cache_blocks


def test_tokenize_is_the_reference_server_s():
    """Stable, prefix-preserving crc32 word hashing, capped at 24 words in
    the server, as the reference's ``_tokenize``."""
    ref_srv = _server(_sides()[0])
    srv = _server(_sides()[1])
    reqs = _reqs(_sides()[1], 24)
    for r, rr in zip(reqs, _reqs(_sides()[0], 24)):
        for cap in (24, 64):
            np.testing.assert_array_equal(
                srv._tokenize(r, 1000, cap=cap),
                ref_srv._tokenize(rr, 1000, cap=cap))
        np.testing.assert_array_equal(srv._tokenize(r, 1000),
                                      tokenize(r, 1000, cap=24))
    req = reqs[0]
    toks = srv._tokenize(req, vocab=1000)
    assert toks[0] == zlib.crc32(req.text.split()[0].encode()) % 1000
    longer = dataclasses.replace(req, text=req.text + " extra tail words",
                                 prompt_tokens=req.prompt_tokens + 3)
    t1 = srv._tokenize(req, vocab=1000, cap=64)
    np.testing.assert_array_equal(
        srv._tokenize(longer, vocab=1000, cap=64)[:len(t1)], t1)


def test_recover_node_uses_simulated_clock():
    def script(s):
        srv = _server(s, dict(ECFG, max_new_tokens=2))
        _submit(s, srv, _reqs(s, 4), 2)
        srv.fail_node(1)
        srv.step()
        srv.recover_node(1)
        hb = srv.monitor.stats[1].last_heartbeat
        ticks, healthy = srv.ticks, bool(srv.monitor.healthy_mask()[1])
        srv.run()
        return srv, (hb, ticks, healthy)
    _, (hb, ticks, healthy) = _compare(script)
    assert healthy and hb == ticks     # scheduler ticks, not wall time


# ---------------------------------------------------------------------------
# disaggregated handoffs (tests/test_disagg.py)
# ---------------------------------------------------------------------------
DISAGG = dict(ECFG, max_new_tokens=3, **PAGED)


def _pair_node(srv):
    return np.asarray(srv.router.arrays.pair_node)


def _split_route(srv):
    """First route whose prefill and decode legs live on different nodes."""
    arr = srv.router.arrays
    rp, rq = np.asarray(arr.route_prefill), np.asarray(arr.route_decode)
    pn = _pair_node(srv)
    r = next(i for i in range(len(rp)) if pn[rp[i]] != pn[rq[i]])
    return int(rp[r]), int(rq[r])


def test_disagg_server_serves_all_with_handoffs():
    def script(s):
        srv = _server(s, DISAGG, single=True, policy="disagg")
        _submit(s, srv, _reqs(s, 10, long=True), 3)
        return srv, srv.run()
    srv, done = _compare(script)
    assert sorted(done) == list(range(10))
    stats = srv.stats()
    assert stats["handoffs"] >= 1 and stats["transfers_inflight"] == 0
    _assert_conserved(srv)
    _assert_no_leaks(srv)


@pytest.mark.parametrize("leg", ["prefill", "decode"])
def test_handoff_endpoint_death_mid_transfer(leg):
    """A schedule-driven crash of the prefill node (before delivery) or of
    the decode node (mid-flight): the transfer aborts, the request
    re-dispatches to completion, and no pin outlives it."""
    def script(s):
        probe = _server(s, DISAGG, single=True, policy="disagg")
        p, q = _split_route(probe)
        node = int(_pair_node(probe)[p if leg == "prefill" else q])
        sched = s.F.FaultSchedule(crashes=(s.F.CrashWindow(node, 1.0,
                                                           10.0 ** 9),))
        srv = _server(s, DISAGG, single=True, policy="disagg",
                      faults=sched)
        ok = srv._start_handoff(s.SR(request_id=0,
                                     req=_reqs(s, 1, long=True)[0],
                                     max_new_tokens=3), p, q)
        pinned = _active_blocks(srv.engines[p])
        done = srv.run()
        return srv, (ok, pinned, p, node, done)
    srv, (ok, pinned, p, node, done) = _compare(script)
    assert ok and pinned > 0
    assert not srv.transfers
    assert 0 in done and len(done[0]["tokens"]) == 3
    assert srv.stats()["reroutes"] >= 1
    assert _active_blocks(srv.engines[p]) == 0
    _assert_conserved(srv)
    for pr, eng in srv.engines.items():
        eng.kv.cache.check_invariants()
        if int(srv.router.arrays.pair_node[pr]) == node:
            assert eng.kv.cache.pool.n_free == PAGED["cache_blocks"]


# ---------------------------------------------------------------------------
# chaos (tests/test_faults.py)
# ---------------------------------------------------------------------------
FAULTY = dict(ECFG, **PAGED)


def test_tick_clock_server_never_marks_live_nodes_stale():
    def script(s):
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE)
        for _ in range(10 * int(srv.monitor.heartbeat_timeout) + 5):
            srv.step()
        return srv, (list(srv.monitor.healthy_mask()), srv.monitor.now)
    srv, (healthy, now) = _compare(script)
    assert all(healthy) and now == srv.ticks


def test_heartbeat_loss_masks_routing_but_not_progress():
    def script(s):
        sched = s.F.FaultSchedule(
            heartbeat_losses=(s.F.HeartbeatLoss(0, 0.0, 40.0),))
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE, faults=sched)
        for _ in range(int(srv.monitor.heartbeat_timeout) + 2):
            srv.step()
        dark = (bool(srv.monitor.healthy_mask()[0]), 0 in srv._down_nodes)
        _submit(s, srv, _reqs(s, 6), 3)
        pairs = [fl.pair for fl in srv.inflight.values()]
        done = srv.run()
        for _ in range(45):
            srv.step()
        return srv, (dark, pairs, done, bool(srv.monitor.healthy_mask()[0]))
    srv, (dark, pairs, done, revived) = _compare(script)
    assert dark == (False, False)        # stale -> routing-masked, alive
    assert all(int(srv.router.arrays.pair_node[p]) != 0 for p in pairs)
    assert sorted(done) == list(range(6)) and revived
    _assert_conserved(srv)


def test_straggler_slow_credit_gates_progress():
    def script(s):
        sched = s.F.FaultSchedule(
            stragglers=(s.F.Straggler(1, 0.0, 1000.0, 2.0),))
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE, faults=sched)
        adv = []
        for _ in range(8):
            srv.step()
            adv.append(bool(srv._advance[1]))
            assert all(srv._advance[[0, 2, 3]])
        return srv, adv
    _, adv = _compare(script)
    assert adv == [False, True] * 4


def test_transient_errors_retry_to_completion():
    def script(s):
        sched = s.F.FaultSchedule(
            transient=s.F.TransientErrors(rate=0.5, seed=11))
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE, faults=sched)
        _submit(s, srv, _reqs(s, 12), 3)
        return srv, srv.run()
    srv, done = _compare(script)
    assert sorted(done) == list(range(12))
    st = srv.stats()
    assert st["transient_faults"] > 0 and st["retries"] > 0
    _assert_conserved(srv)
    _assert_no_leaks(srv)


def test_timeouts_retry_within_budget():
    def script(s):
        rcfg = s.Res(request_timeout_ticks=3, min_timeout_ticks=1,
                     deadline_timeout_factor=1e9, max_retries=1,
                     backoff_base_ticks=1.0)
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE, resilience=rcfg)
        _submit(s, srv, _reqs(s, 8), 6)
        return srv, srv.run()
    srv, done = _compare(script)
    assert sorted(done) == list(range(8))
    st = srv.stats()
    rcfg = srv.resilience
    assert st["timeouts"] > 0 and st["retries"] == st["timeouts"]
    assert st["retries"] <= max(rcfg.retry_budget_min, int(
        rcfg.retry_budget_frac * sum(s.total_dispatched
                                     for s in srv.monitor.stats.values())))
    _assert_conserved(srv)
    _assert_no_leaks(srv)


def test_shedding_by_slo_class():
    def script(s):
        rcfg = s.Res(shed_threshold=0.5, shed_interactive_threshold=3.0)
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE, resilience=rcfg)
        statuses = {}
        for i, r in enumerate((_reqs(s, 24) * 2)[:40]):
            cls = "batch" if i % 2 else "interactive"
            srv.submit(s.SR(request_id=i, req=r, max_new_tokens=4,
                            slo_class=cls))
            d = srv.done.get(i)
            if isinstance(d, dict) and d.get("status") == "shed":
                statuses[i] = cls
        return srv, (statuses, srv.run())
    srv, (statuses, done) = _compare(script)
    assert statuses and set(statuses.values()) == {"batch"}
    assert len(done) == 40 and srv.stats()["sheds"] == len(statuses)
    _assert_conserved(srv)
    _assert_no_leaks(srv)


@pytest.mark.parametrize("policy", runtime_policies())
def test_retry_hedge_failover_conservation(policy):
    """Aggressive hedging, tight timeouts with retries, transient errors
    and a schedule-driven crash mid-run, under every runtime policy."""
    def script(s):
        sched = s.F.FaultSchedule(
            crashes=(s.F.CrashWindow(1, 3.0, 10.0 ** 9),),
            transient=s.F.TransientErrors(rate=0.3, seed=11))
        rcfg = s.Res(request_timeout_ticks=6, min_timeout_ticks=4,
                     deadline_timeout_factor=1e9, max_retries=2,
                     backoff_base_ticks=1.0)
        srv = _server(s, FAULTY, policy=policy, hedge_after=2,
                      faults=sched, resilience=rcfg)
        _submit(s, srv, _reqs(s, 10), 4)
        return srv, srv.run(max_ticks=4000)
    srv, done = _compare(script)
    assert sorted(done) == list(range(10))
    _assert_conserved(srv)
    _assert_no_leaks(srv)


def test_phase_b_exception_releases_pins():
    """An engine blowing up mid-commit is a node crash: its flights
    re-route, its pools flush, and nothing stays pinned."""
    def script(s):
        srv = _server(s, FAULTY, hedge_after=NO_HEDGE)
        _submit(s, srv, _reqs(s, 8), 4)
        victim_pair = next(iter(srv.inflight.values())).pair
        eng = srv.engines[victim_pair]
        boom = {"armed": True}

        def exploding_commit(work):
            if boom.pop("armed", False):
                raise RuntimeError("injected mid-commit fault")
            return type(eng)._commit_chunk(eng, work)

        def exploding_step(*a, **k):
            if boom.pop("armed", False):
                raise RuntimeError("injected mid-commit fault")
            return type(eng).step(eng)
        eng._commit_chunk = exploding_commit
        eng.step = exploding_step
        done = srv.run(max_ticks=4000)
        return srv, (done, int(_pair_node(srv)[victim_pair]))
    srv, (done, victim_node) = _compare(script)
    assert sorted(done) == list(range(8))
    assert victim_node in srv._down_nodes
    assert srv.stats()["reroutes"] >= 1
    _assert_conserved(srv)
    _assert_no_leaks(srv)


# ---------------------------------------------------------------------------
# the serving launcher (repro.launch.serve)
# ---------------------------------------------------------------------------
def _ref_launch(thresholds, n, fail_node=None, fail_at=5, max_new=4):
    """The reference launcher's main() on the f32 models, piece by piece."""
    trace = ref_build_trace(max(n, 64), seed=0)
    srv = RefServer(ref_testbed(), _builders(0), thresholds,
                    RefEngineConfig(max_slots=2, max_seq=48,
                                    max_new_tokens=max_new))
    for i, r in enumerate(trace.requests[:n]):
        srv.submit(RefServeRequest(request_id=i, req=r,
                                   max_new_tokens=max_new))
        if fail_node is not None and i == fail_at:
            srv.fail_node(fail_node)
    return srv, srv.run()


@pytest.mark.parametrize("fail", [None, 1])
def test_launcher_smoke_serves_as_the_reference_launcher(fail):
    run = launch.run_launch(8, device="cpu", smoke=True,
                            models=_builders(1), fail_node=fail, fail_at=3)
    ref_srv, want = _ref_launch(PAPER_DEFAULTS, 8, fail_node=fail,
                                fail_at=3)
    assert run.done == want and sorted(want) == list(range(8))
    assert run.server.stats() == ref_srv.stats()
    assert run.chunk == 1 and set(run.budgets.values()) == {4}
    assert len(run.server._cohorts) == 2
    assert sorted(len(c) for c in run.server._cohorts) == [1, 9]


def test_launcher_tuned_thresholds_outcome():
    """NSGA-II streams differ between the packages, so a tuned run is
    compared by outcome: the reference's fitness re-scores the port's
    chosen genome to the port's objectives, and the port's server given
    the reference's chosen genome serves as the reference launcher does."""
    gens = 3
    trace = build_trace(64, seed=0)
    tuned = launch.tune_thresholds(trace, gens, "cpu")
    assert tuned.thresholds.shape == (6,)
    assert np.all(tuned.thresholds >= np.asarray(BOUNDS_LO) - 1e-6)
    assert np.all(tuned.thresholds <= np.asarray(BOUNDS_HI) + 1e-6)
    ref_ev = RefEvaluator(ref_build_trace(64, seed=0), ref_testbed(),
                          RefEvalConfig(concurrency=4))
    fit = ref_ev.make_fitness("threshold")
    F, _ = fit(jnp.asarray(tuned.thresholds)[None], jax.random.key(0))
    np.testing.assert_allclose(tuned.objectives, np.asarray(F)[0],
                               rtol=1e-5, atol=1e-12)
    # the reference launcher's tuning, then both servers on its genome
    opt = RefNSGA2(fit, RefNSGA2Config(pop_size=launch.POP,
                                       n_generations=gens,
                                       lo=jnp.asarray(BOUNDS_LO),
                                       hi=jnp.asarray(BOUNDS_HI)))
    state = opt.evolve_scan(jax.random.key(0), gens)
    ref_thr, _ = opt.select_by_weights(state, jnp.array([1 / 3] * 3))
    ref_thr = np.asarray(ref_thr, np.float32)
    run = launch.run_launch(6, device="cpu", smoke=True,
                            models=_builders(1), thresholds=ref_thr)
    ref_srv, want = _ref_launch(ref_thr, 6)
    assert run.done == want and run.server.stats() == ref_srv.stats()


@pytest.mark.parametrize("tune", [False, True])
def test_launcher_main_smoke_cpu(tune, capsys):
    argv = ["--smoke", "--device", "cpu", "--requests", "4", "--fail-node",
            "2", "--fail-at", "1"]
    if tune:
        argv += ["--optimize-router", "--generations", "2"]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out
    assert ("NSGA-II: pop 48 x 2 generations" in out) == tune
    assert "'reroutes'" in out
