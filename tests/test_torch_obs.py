"""The port's observability copies (``repro_torch.obs``) held against
``repro.obs``: the same calls must leave both in the same state — tracer
rings and drop counts, histograms, the metrics registry's label merge and
grouped ingest, counter vectors, the flat export, and the audit ring — and
a traced ``ClusterServer`` must emit the reference server's span streams,
audit records and percentiles, fleet on, through failover, hedging and KV
handoffs. Twins of ``tests/test_obs.py``'s primitive and serving tests."""
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.cluster.spec import disagg_testbed as ref_disagg_testbed
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.configs import get as ref_get
from repro.core.policy import PAPER_DEFAULTS
from repro.models import lm as rlm
from repro.serving import ClusterServer as RefServer
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import ServeRequest as RefServeRequest
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch import obs
from repro_torch.cluster.spec import disagg_testbed, paper_testbed
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serving import ClusterServer, EngineConfig, ServeRequest
from repro_torch.workload.trace import build_trace

EDGE_NAMES = ("qwen2.5:1.5b-instruct", "qwen2.5-coder:1.5b-instruct",
              "qwen2.5-math:1.5b-instruct")
PKGS = [pytest.param(robs, id="reference"), pytest.param(obs, id="port")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops; with several test processes on the
    machine, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# primitives: each test runs on both packages and compares their states
# ---------------------------------------------------------------------------
def _both(fn):
    """``fn(package)`` on the reference and on the port; equal results."""
    want, got = fn(robs), fn(obs)
    assert got == want
    return got


def test_tracer_ring_eviction_counts_drops():
    def run(o):
        tr = o.Tracer(capacity=4)
        for i in range(7):
            tr.begin(i, float(i))
            tr.end(i, float(i) + 1)
        return len(tr), tr.dropped, [s.key() for s in tr.spans()]
    n, dropped, keys = _both(run)
    assert (n, dropped) == (4, 3)
    assert [k[0] for k in keys] == [3, 4, 5, 6]


@pytest.mark.parametrize("o", PKGS)
def test_tracer_double_open_and_double_close_raise(o):
    tr = o.Tracer()
    tr.begin(0, 0.0)
    with pytest.raises(ValueError):
        tr.begin(0, 1.0)
    tr.end(0, 2.0)
    with pytest.raises(ValueError):
        tr.end(0, 3.0)


def test_noop_tracer_is_inert():
    t = obs.NOOP_TRACER
    t.begin(0, 0.0)
    t.event(0, "dispatch", 0.0, node=1)
    t.phase(0, "serve", 0.0, 1.0)
    t.end(0, 1.0)
    assert len(t) == 0 and t.spans() == []
    assert not t.enabled
    o = obs.Obs.noop()
    assert not o.enabled and o.metrics is None and o.audit is None
    assert obs.Obs().enabled == robs.Obs().enabled


def test_histogram_states_equal_the_reference():
    """Vector and scalar ingest, merge, percentiles and degenerate
    distributions: bucket counts and every summary equal the reference's."""
    rng = np.random.default_rng(0)
    a, b = rng.lognormal(0, 2, 3000), rng.lognormal(1, 3, 500)

    def run(o):
        hv, hs, hz, he = o.Histogram(), o.Histogram(), o.Histogram(), \
            o.Histogram()
        hv.observe(a)
        for v in b:
            hs.observe_one(v)
        hv.merge(hs)
        hz.observe(np.zeros(10))
        return (hv.counts.tolist(), hv.n, hv.total, hv.vmin, hv.vmax,
                hv.mean, [hv.percentile(q) for q in (0, 50, 95, 99, 100)],
                hz.percentile(50), hz.percentile(99),
                math.isnan(he.percentile(50)))
    got = _both(run)
    assert got[7] == got[8] == 0.0 and got[9]


def test_registry_label_merge_and_observe_by():
    rng = np.random.default_rng(3)
    v0, v1 = rng.lognormal(0, 1, 200), rng.lognormal(1, 1, 200)

    def run(o):
        m = o.MetricsRegistry()
        m.observe("ttft", v0, node=0, category=2)
        m.observe("ttft", v1, node=1, category=2)
        m.observe_by("tpot", np.array([1.0, 2.0, 3.0, 4.0]),
                     np.array([0, 1, 0, 1]), np.array([5, 5, 6, 6]))
        return (m.percentiles("ttft", node=None, category=2),
                m.percentiles("ttft"), m.percentiles("ttft", node=0,
                                                     category=2),
                m.percentiles("tpot"), m.percentiles("tpot", node=0,
                                                     category=5),
                m.labels("tpot"), m.summary())
    by_cat, overall, one, tpot, tpot05, labels, _ = _both(run)
    assert by_cat["n"] == overall["n"] == 400
    assert by_cat["p95"] == overall["p95"] and one["n"] == 200
    assert tpot["n"] == 4 and tpot05["n"] == 1
    assert labels == [(0, 5), (0, 6), (1, 5), (1, 6)]


def test_counter_vec_and_gauge():
    def run(o):
        m = o.MetricsRegistry()
        c = m.counter("fleet_tokens_emitted", 4)
        c.add(2, 5)
        c.add(np.array([0, 0, 3]), np.array([1, 1, 7]))
        c.add()
        m.gauge("drift", 2).set(0.25, idx=1)
        return (c.values.tolist(), int(c.total),
                {k: v.tolist() for k, v in m.counters().items()},
                {k: v.tolist() for k, v in m.gauges().items()})
    values, total, _, gauges = _both(run)
    assert values == [3, 0, 5, 7] and total == 15
    assert gauges == {"drift": [0.0, 0.25]}


def test_metrics_flat_keys():
    def run(o):
        m = o.MetricsRegistry()
        m.observe("latency", [1.0, 2.0], node=3)
        m.counter("fleet_tokens_emitted", 2).add(1, 9)
        m.gauge("drift").set(0.25)
        return o.metrics_flat(m)
    flat = _both(run)
    assert "latency.p50" in flat and "latency.node3.p95" in flat
    assert flat["fleet_tokens_emitted.total"] == 9.0
    assert flat["fleet_tokens_emitted.node1"] == 9.0
    assert flat["drift"] == 0.25


def test_audit_ring_and_explain():
    def run(o):
        al = o.AuditLog(capacity=3)
        for i in range(5):
            al.record(i, float(i), "threshold", "pair", (0.5,), i % 2, i % 2,
                      i % 2, healthy=np.ones(4), queue=np.zeros(4),
                      up=np.arange(4.0), prefill=np.arange(4.0),
                      tpot=np.arange(4.0), cost=np.arange(4.0),
                      failover="node-down" if i == 4 else None)
        return (len(al), al.dropped, al.counts_by_policy(),
                [r.index for r in al.failovers()],
                [r.key() for r in al.records()], al.explain(4),
                al.explain(0))
    n, dropped, counts, failovers, _, txt, missing = _both(run)
    assert n == 3 and dropped == 2
    assert counts == {"threshold": 3} and failovers == [4]
    assert "policy=threshold" in txt and "failover[node-down]" in txt
    assert "<-- chosen" in txt
    assert missing == "request 0: no audit record"


def test_chrome_trace_equals_the_reference(tmp_path):
    def run(o):
        tr = o.Tracer()
        for i in range(3):
            tr.begin(i, float(i))
            tr.set_category(i, i % 2)
            tr.event(i, "dispatch", float(i), node=i % 2, pair=i)
            tr.phase(i, "serve", float(i), 2.0, i % 2)
            tr.end(i, float(i) + 2.0, "completed")
        return o.chrome_trace(tr, time_unit=0.05)
    doc = _both(run)
    path = tmp_path / "trace.json"
    assert obs.chrome_trace(obs.Tracer(), path=str(path)) == json.loads(
        path.read_text())
    assert doc["traceEvents"]


# ---------------------------------------------------------------------------
# a traced ClusterServer against the reference's (f32 weights shared)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _models(name: str, seed: int):
    rcfg = dataclasses.replace(ref_get(name).smoke(), dtype="float32")
    cfg = dataclasses.replace(get(name).smoke(), dtype="float32")
    params = rlm.init(jax.random.key(seed), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return (rcfg, params), (cfg, model)


def _builders(disagg=False):
    big = _models("stablelm-3b", 0)
    if disagg:
        return {"gemma3:27b": big[0]}, {"gemma3:27b": big[1]}
    small = _models("qwen3-1.7b", 1)
    ref = {"gemma3:27b": big[0], **{n: small[0] for n in EDGE_NAMES}}
    port = {"gemma3:27b": big[1], **{n: small[1] for n in EDGE_NAMES}}
    return ref, port


def _long(reqs):
    return [dataclasses.replace(r, text=" ".join(f"w{i}_{j}"
                                                 for j in range(20)),
                                prompt_tokens=20)
            for i, r in enumerate(reqs)]


def _traced(n_req, ecfg, fail=(), disagg=False, **kw):
    """The same traced run on both packages: (reference, port) servers and
    their Obs bundles."""
    out = []
    bld = _builders(disagg)
    for side, (Server, EC, SR, make_obs, testbed, trace, models) in enumerate(
            ((RefServer, RefEngineConfig, RefServeRequest, robs.Obs,
              ref_disagg_testbed if disagg else ref_testbed,
              ref_build_trace, bld[0]),
             (ClusterServer, EngineConfig, ServeRequest, obs.Obs,
              disagg_testbed if disagg else paper_testbed, build_trace,
              bld[1]))):
        o = make_obs()
        extra = {} if side == 0 else {"device": "cpu"}
        srv = Server(testbed(), models, PAPER_DEFAULTS, EC(**ecfg), obs=o,
                     **kw, **extra)
        reqs = trace(24, seed=5).requests[:n_req]
        if disagg:
            reqs = _long(reqs)
        for i, r in enumerate(reqs):
            srv.submit(SR(request_id=i, req=r,
                          max_new_tokens=ecfg["max_new_tokens"]))
        for node in fail:
            srv.fail_node(node)
        done = srv.run()
        out.append((srv, o, done))
    (rs, ro, rd), (ps, po, pd) = out
    assert pd == rd
    assert ps.stats() == rs.stats()
    keys = lambda t: [s.key() for s in sorted(t.spans(),
                                              key=lambda s: s.request_id)]
    assert keys(po.tracer) == keys(ro.tracer)
    assert [r.key() for r in po.audit.records()] == \
        [r.key() for r in ro.audit.records()]
    assert obs.metrics_flat(ps.metrics) == robs.metrics_flat(rs.metrics)
    return ps, po


def _event_counts(tracer):
    ev = {}
    for s in tracer.spans():
        for e in s.events:
            if e.name in ("dispatch", "complete", "failure", "cancel"):
                node = dict(e.attrs)["node"]
                ev.setdefault(node, {"dispatch": 0, "complete": 0,
                                     "failure": 0, "cancel": 0})
                ev[node][e.name] += 1
    return ev


def _assert_spans_mirror_monitor(srv, o, n_req):
    spans = o.tracer.spans()
    assert len(spans) == n_req and not o.tracer.open_spans()
    ev = _event_counts(o.tracer)
    for node, st in srv.monitor.stats.items():
        got = ev.get(node, {"dispatch": 0, "complete": 0, "failure": 0,
                            "cancel": 0})
        assert got["dispatch"] == st.total_dispatched, (node, got)
        assert got["complete"] == st.total_completed, (node, got)
        assert got["failure"] == st.total_failed, (node, got)
        assert got["cancel"] == st.total_cancelled, (node, got)
        assert got["dispatch"] == (got["complete"] + got["failure"]
                                   + got["cancel"]), node
    for s in spans:
        assert s.status == "completed"
        for p in s.phases:
            assert s.start <= p.start and p.start + p.duration <= s.end


def test_serving_spans_mirror_monitor_accounting(tmp_path):
    srv, o = _traced(8, dict(max_slots=2, max_seq=48, max_new_tokens=3))
    _assert_spans_mirror_monitor(srv, o, 8)
    st = srv.stats()
    assert st["percentiles"]["latency"]["n"] == 8
    assert st["percentiles"]["ttft"]["n"] == 8
    assert len(o.audit) >= 8
    path = tmp_path / "serve_trace.json"
    doc = obs.chrome_trace(o.tracer, path=str(path),
                           time_unit=srv.tick_seconds)
    assert json.loads(path.read_text()) == doc


def test_serving_failover_reroutes_traced():
    srv, o = _traced(6, dict(max_slots=2, max_seq=48, max_new_tokens=4),
                     fail=(1, 2, 3))
    _assert_spans_mirror_monitor(srv, o, 6)
    n_reroute = sum(1 for s in o.tracer.spans()
                    for e in s.events if e.name == "reroute")
    assert n_reroute == srv.stats()["reroutes"] >= 1


def test_serving_hedged_cancel_traced():
    srv, o = _traced(6, dict(max_slots=1, max_seq=48, max_new_tokens=4),
                     hedge_after=2)
    _assert_spans_mirror_monitor(srv, o, 6)
    n_hedge = sum(1 for s in o.tracer.spans()
                  for e in s.events if e.name == "hedge")
    assert n_hedge == srv.stats()["hedges"] >= 1


def test_serving_disagg_handoff_traced():
    srv, o = _traced(8, dict(max_slots=2, max_seq=48, max_new_tokens=3,
                             prefix_cache=True, block_size=8,
                             cache_blocks=32),
                     disagg=True, router_kwargs={"mode": "disagg"})
    _assert_spans_mirror_monitor(srv, o, 8)
    spans = o.tracer.spans()
    n_handoff = sum(1 for s in spans for e in s.events
                    if e.name == "handoff-start")
    assert n_handoff == srv.stats()["handoffs"] >= 1
    kv_phases = [p for s in spans for p in s.phases
                 if p.name == "kv-transfer"]
    assert srv.stats()["percentiles"]["transfer"]["n"] == len(kv_phases)
