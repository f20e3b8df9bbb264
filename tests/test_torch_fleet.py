"""Fleet cohorts in the port against the reference's ``ClusterServer``.

With the same f32 weights and requests, the port's server must give the
reference server's ``done`` dicts (tokens, QoE records, tick latencies),
``stats()``, routing decisions (audit records: pair, node, route) and span
streams exactly, fleet on and off, under every runtime routing policy,
chunked, through KV handoffs and node failures mid-chunk.
Beside that, the port's own fleet contracts: a saturated tick is one
dispatch per cohort and one ``lm.decode_step`` over all of a cohort's rows,
the numpy fleet counters track the engines, and a member skipped by a
dispatch keeps its state. Twins of ``tests/test_fleet.py``.

Hedging is off in the identity runs (``hedge_after=10**9``), as in the
reference's: a hedged loser's cancel lands one iteration later in fleet
mode, a documented caveat that the port mirrors.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.cluster.spec import disagg_testbed as ref_disagg_testbed
from repro.cluster.spec import fleet_testbed as ref_fleet_testbed
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.configs import get as ref_get
from repro.core.policies import runtime_policies
from repro.core.policy import PAPER_DEFAULTS
from repro.models import lm as rlm
from repro.obs import Obs as RefObs
from repro.serving import ClusterServer as RefServer
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import ServeRequest as RefServeRequest
from repro.workload.sessions import SessionConfig as RefSessionConfig
from repro.workload.sessions import build_session_trace as ref_sessions
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch.cluster.spec import (disagg_testbed, fleet_testbed,
                                      paper_testbed)
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.policies import runtime_policies as port_policies
from repro_torch.models import lm
from repro_torch.obs import Obs
from repro_torch.serving import (ClusterServer, EngineConfig, LLMEngine,
                                 ServeRequest)
from repro_torch.serving import fleet as fleet_mod
from repro_torch.workload.sessions import SessionConfig, build_session_trace
from repro_torch.workload.trace import build_trace

NO_HEDGE = 10**9
EDGE_NAMES = ("qwen2.5:1.5b-instruct", "qwen2.5-coder:1.5b-instruct",
              "qwen2.5-math:1.5b-instruct")
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


def _builders(single=False):
    """(reference, port) model maps: stablelm-3b's smoke config for the
    cloud name, one qwen3-1.7b smoke model shared by the three edge names
    (the edge engines form one cohort); ``single`` maps the disaggregated
    testbed's one model name."""
    big = _models("stablelm-3b", 0)
    if single:
        return {"gemma3:27b": big[0]}, {"gemma3:27b": big[1]}
    small = _models("qwen3-1.7b", 1)
    return ({"gemma3:27b": big[0], **{n: small[0] for n in EDGE_NAMES}},
            {"gemma3:27b": big[1], **{n: small[1] for n in EDGE_NAMES}})


def _long(reqs):
    """Prompts spanning >= 2 whole KV blocks, so a handoff has payload."""
    return [dataclasses.replace(r, text=" ".join(f"w{i}_{j}"
                                                 for j in range(20)),
                                prompt_tokens=20)
            for i, r in enumerate(reqs)]


def _port_server(fleet, policy="threshold", ecfg=ECFG, disagg=False,
                 obs=None):
    return ClusterServer(disagg_testbed() if disagg else paper_testbed(),
                         _builders(disagg)[1], PAPER_DEFAULTS,
                         EngineConfig(**ecfg), hedge_after=NO_HEDGE,
                         fleet=fleet, router_kwargs={"mode": policy},
                         obs=obs, device="cpu")


def _drive(srv, reqs, chunk, max_new, Req, mid=None):
    for i, r in enumerate(reqs):
        srv.submit(Req(request_id=i, req=r, max_new_tokens=max_new))
    if mid is not None:
        srv.step(chunk=chunk)
        srv.step(chunk=chunk)
        mid(srv)
    return srv.run(chunk=chunk)


def _both(fleet, reqs, chunk, max_new=4, policy="threshold", ecfg=ECFG,
          disagg=False, mid=None):
    """One traced run on each package: their results, stats, routing
    decisions (every (pair, node, route) the audit recorded) and span
    streams must be equal."""
    r_obs, p_obs = RefObs(), Obs()
    ref = RefServer(ref_disagg_testbed() if disagg else ref_testbed(),
                    _builders(disagg)[0], PAPER_DEFAULTS,
                    RefEngineConfig(**ecfg), hedge_after=NO_HEDGE,
                    fleet=fleet, router_kwargs={"mode": policy}, obs=r_obs)
    want = _drive(ref, reqs[0], chunk, max_new, RefServeRequest, mid)
    srv = _port_server(fleet, policy, ecfg, disagg, obs=p_obs)
    got = _drive(srv, reqs[1], chunk, max_new, ServeRequest, mid)
    assert sorted(got) == sorted(want) == list(range(len(reqs[1])))
    assert got == want
    assert srv.stats() == ref.stats()
    assert [r.key() for r in p_obs.audit.records()] == \
        [r.key() for r in r_obs.audit.records()]
    assert [s.key() for s in p_obs.tracer.spans()] == \
        [s.key() for s in r_obs.tracer.spans()]
    return srv


@functools.lru_cache(maxsize=None)
def _trace(n):
    return (ref_build_trace(24, seed=5).requests[:n],
            build_trace(24, seed=5).requests[:n])


def test_runtime_policies_are_the_reference_s():
    assert port_policies() == runtime_policies()


# ---------------------------------------------------------------------------
# the port's server == the reference's, fleet on and off
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("policy", runtime_policies())
def test_server_equals_reference_across_policies(policy, chunk, fleet):
    _both(fleet, _trace(10), chunk, max_new=6 if chunk > 1 else 4,
          policy=policy)


@pytest.mark.parametrize("fleet", [False, True])
def test_disagg_handoffs_mid_chunk(fleet):
    """Prefilled KV rides the transfer queue and lands between chunks; the
    results equal the reference's and no block leaks."""
    reqs = tuple(_long(r) for r in _trace(8))
    ecfg = dict(ECFG, max_new_tokens=3, **PAGED)
    srv = _both(fleet, reqs, 2, max_new=3, policy="disagg", ecfg=ecfg,
                disagg=True)
    assert srv.stats()["handoffs"] >= 1
    for eng in srv.engines.values():
        eng.kv.cache.check_invariants()
        assert int(np.sum(eng.kv.cache.pool.ref > 0)) == 0


@pytest.mark.parametrize("fleet", [False, True])
def test_node_failure_mid_chunk(fleet):
    """``fail_node`` kills a cohort member two ticks in: the results equal
    the reference's and the dead member's pool restarts empty, re-homed onto
    its slice of the cohort's pools."""
    srv = _both(fleet, _trace(10), 2, ecfg=dict(ECFG, **PAGED),
                mid=lambda s: s.fail_node(1))
    pair_node = srv.router.arrays.pair_node
    for p, eng in srv.engines.items():
        eng.kv.cache.check_invariants()
        if int(pair_node[p]) == 1:
            assert eng.kv.cache.pool.n_free == eng.ecfg.cache_blocks
            assert not eng.kv.k.any() and not eng.kv.v.any()
            if fleet:
                cohort, m = eng._fleet
                assert eng.kv.k.data_ptr() == cohort.kv_pools.k[m].data_ptr()


def test_mixed_workload():
    """Session traffic with prefix reuse, disaggregated handoffs and a node
    failure mid-run, chunked, fleet on: the reference's results."""
    ref_tr = ref_sessions(RefSessionConfig(n_sessions=4, mean_turns=3.0),
                          seed=3, n_requests=10)
    tr = build_session_trace(SessionConfig(n_sessions=4, mean_turns=3.0),
                             seed=3, n_requests=10)

    def pad(reqs):
        return [dataclasses.replace(r, text=r.text + " " + " ".join(
            f"pad{i}_{j}" for j in range(12)),
            prompt_tokens=r.prompt_tokens + 12) for i, r in enumerate(reqs)]
    srv = _both(True, (pad(ref_tr.requests), pad(tr.requests)), 2,
                max_new=3, policy="disagg",
                ecfg=dict(ECFG, max_new_tokens=3, **PAGED), disagg=True,
                mid=lambda s: s.fail_node(1))
    assert srv.stats()["handoffs"] >= 1
    for eng in srv.engines.values():
        eng.kv.cache.check_invariants()


# ---------------------------------------------------------------------------
# completion latency in ticks, not decode iterations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fleet", [False, True])
def test_completion_latency_in_ticks_under_chunking(fleet):
    srv = _port_server(fleet, ecfg=dict(ECFG, max_new_tokens=8))
    seen = []
    orig = srv.monitor.on_complete
    srv.monitor.on_complete = (
        lambda node, latency: (seen.append(latency), orig(node, latency))[1])
    _drive(srv, _trace(6)[1], 4, 8, ServeRequest)
    assert seen
    assert all(1 <= lat <= srv.ticks for lat in seen), (seen, srv.ticks)
    assert min(seen) < 8


# ---------------------------------------------------------------------------
# one dispatch per cohort, fleet counters, skipped members
# ---------------------------------------------------------------------------
def test_saturated_tick_is_one_dispatch_per_cohort(monkeypatch):
    """With every engine busy, a tick is ``len(cohorts)`` dispatches, each
    one ``lm.decode_step`` over all of its cohort's rows (9 edge members x
    2 slots, then the cloud's 2), where the reference runs a vmapped
    chunk."""
    srv = _port_server(True)
    assert len(srv._cohorts) == 2
    assert sorted(len(c) for c in srv._cohorts) == [1, 9]
    for i, pair in enumerate(srv.engines):
        srv._dispatch(ServeRequest(request_id=100 + i,
                                   req=_trace(12)[1][i % 12],
                                   max_new_tokens=4), pair)
    assert all(e.active_count > 0 for e in srv.engines.values())
    rows = []
    orig = lm.decode_step

    def counted(model, cfg, token, cache):
        rows.append(token.shape[0])
        return orig(model, cfg, token, cache)
    monkeypatch.setattr(lm, "decode_step", counted)
    before = srv.decode_dispatches
    srv.step()
    assert srv.decode_dispatches - before == len(srv._cohorts)
    assert rows == [2, 18]          # pair order: the cloud cohort first
    assert all(e._steps == 1 for e in srv.engines.values())
    assert all(e.decode_iterations == 0 for e in srv.engines.values())


def test_fleet_counters_match_engine_ground_truth():
    srv = _port_server(True)
    for i, r in enumerate(_trace(12)[1]):
        srv.submit(ServeRequest(request_id=i, req=r, max_new_tokens=4))
    while srv.inflight:
        assert srv.active_count == sum(e.active_count
                                       for e in srv.engines.values())
        assert srv.queue_len == sum(e.queue_len
                                    for e in srv.engines.values())
        srv.step()
    st = srv.stats()
    assert st["active"] == 0 and st["queued"] == 0
    assert st["fleet"]["emitted"] == sum(c["emitted"] for c in st["cohorts"])
    assert st["fleet"]["emitted"] == sum(e.tokens_emitted
                                         for e in srv.engines.values())
    assert st["fleet"]["retired"] == len(srv.done)
    assert sum(c["dispatches"] for c in st["cohorts"]) >= 1
    assert st["decode_dispatches"] >= sum(c["dispatches"]
                                          for c in st["cohorts"])


def test_fleet_testbed_collapses_to_two_cohorts():
    """64 nodes -> 176 pairs -> exactly 2 cohorts (8 and 168 members) when
    the edge names share one model object; the testbed's tables equal the
    reference's."""
    cluster = fleet_testbed(n_edge=56, n_cloud=8)
    want = ref_fleet_testbed(n_edge=56, n_cloud=8).to_arrays()
    for k, v in cluster.arrays_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)), k)
    assert len(cluster.nodes) == 64
    srv = ClusterServer(cluster, _builders()[1], PAPER_DEFAULTS,
                        EngineConfig(**ECFG), fleet=True, device="cpu")
    assert len(srv.engines) == 8 + 56 * 3
    assert sorted(len(c) for c in srv._cohorts) == [8, 168]


def test_skipped_member_state_is_unchanged_by_a_dispatch():
    """A member left out of a dispatch (not eligible, or queued work at
    n > 1) keeps its kv_len, next tokens and cache rows below its fill,
    while the participants advance; the engines' views are the cohort's
    rows, so their slot writes land in its tensors."""
    cfg, model = _models("qwen3-1.7b", 1)[1]
    ecfg = EngineConfig(max_slots=2, max_seq=48, max_new_tokens=4)
    rng = np.random.default_rng(0)
    engines = [LLMEngine(cfg, model, ecfg, device="cpu") for _ in range(3)]
    for i, e in enumerate(engines):
        for s in range(2):
            e.submit(s, rng.integers(0, cfg.vocab, size=5 + 3 * i + s),
                     max_new_tokens=6)
    cohort = fleet_mod.Cohort(engines)
    st = cohort.state
    assert st.cache.k.shape[1] == 6
    for m, e in enumerate(engines):   # views, not copies
        assert e.cache.k.data_ptr() == st.cache.k[:, 2 * m].data_ptr()
        assert e._next_token.data_ptr() == st.next_token[2 * m].data_ptr()
    engines[2].submit(9, rng.integers(0, cfg.vocab, size=4),
                      max_new_tokens=3)   # queued: sits out n > 1
    skipped = (1, 2)
    before = {m: (engines[m].cache.kv_len.clone(),
                  engines[m]._next_token.clone(),
                  engines[m].cache.k.clone(), engines[m].cache.v.clone())
              for m in skipped}
    res = cohort.dispatch(3, eligible=[0, 2])
    assert sorted(res.work) == [0] and res.participants == 1
    assert res.work[0].n_eff == 3 and res.emitted.tolist() == [6, 0, 0]
    for m in skipped:
        kv_len, nxt, k, v = before[m]
        e = engines[m]
        assert torch.equal(e.cache.kv_len, kv_len)
        assert torch.equal(e._next_token, nxt)
        for i, n in enumerate(kv_len.tolist()):
            assert torch.equal(e.cache.k[:, i, :n], k[:, i, :n])
            assert torch.equal(e.cache.v[:, i, :n], v[:, i, :n])
    assert engines[0].cache.kv_len.tolist() == [5 + 3, 6 + 3]
    # the commit of member 0 equals a per-engine step_n on a copy
    solo = LLMEngine(cfg, model, ecfg, device="cpu")
    rng = np.random.default_rng(0)
    for s in range(2):
        solo.submit(s, rng.integers(0, cfg.vocab, size=5 + s),
                    max_new_tokens=6)
    solo.step_n(3)
    engines[0]._commit_chunk(res.work[0])
    assert [s.generated for s in engines[0].slots] == \
        [s.generated for s in solo.slots]
