"""Parity of the port's runtime router and rolling-horizon re-fit with the
JAX package's: the copied arrival generators and monitor are bit-equal to
the originals, the open-mode evaluator gives the reference's assignments
exactly (rows within f32 summation-order tolerance), bucketed tables give
the unpadded rows bit for bit, ``route()`` makes the reference router's
decisions, and a re-fit run on the reference's random draws installs the
reference router's genome. JAX's threefry streams cannot be reproduced in
torch, so the re-fit is compared on the reference's draws (replayed from
``_step_core``'s key splits in a test-only ``evolve_scan``); the router has
no knob for it."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.monitor import ClusterMonitor as RefMonitor
from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import fitness as rf
from repro.core import nsga2 as rn
from repro.core.router import RequestRouter as RefRouter
from repro.workload import arrivals as ra
from repro.workload.slo import attach_slos as ref_attach_slos
from repro_torch import online
from repro_torch.cluster.monitor import ClusterMonitor, NodeStats
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core import baselines
from repro_torch.core import fitness as tf
from repro_torch.core import nsga2 as tn
from repro_torch.core.policies.slo import SLO_DEFAULTS
from repro_torch.core.policies.threshold import (BOUNDS_HI, BOUNDS_LO,
                                                 PAPER_DEFAULTS)
from repro_torch.core.router import RequestRouter
from repro_torch.workload import arrivals as ta
from repro_torch.workload.slo import attach_slos
from repro_torch.workload.trace import build_trace
from test_torch_nsga2 import _reference_draws

RTOL = 1e-5   # f32 sums in another order than XLA's
TRACE_FIELDS = ("task", "pred_category", "pred_conf", "complexity",
                "prompt_tokens", "resp_tokens_mean", "difficulty",
                "query_bytes", "arrival_time", "phase_id")
CALM = dict(rate=0.4, duration=200.0, mix=(0.05, 0.05, 0.85, 0.05))
STORM = dict(rate=8.0, duration=200.0, mix=(0.05, 0.85, 0.05, 0.05),
             length_scale=2.0)
DIURNAL = (dict(rate=1.0, duration=30.0, mix=(0.7, 0.1, 0.1, 0.1)),
           dict(rate=6.0, duration=30.0, mix=(0.1, 0.7, 0.1, 0.1),
                length_scale=1.5),
           dict(rate=2.5, duration=30.0))
ONOFF = (dict(rate=20.0, duration=5.0, length_scale=0.5),
         dict(rate=0.5, duration=5.0, length_scale=3.0))
PHASES = {"poisson": (CALM,), "storm": (STORM,), "mmpp": DIURNAL,
          "onoff": ONOFF}


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _phases(mod, name):
    return tuple(mod.PhaseSpec(**p) for p in PHASES[name])


@functools.lru_cache(maxsize=None)
def _traces(name, n, seed, slos=True):
    tr = ta.build_open_loop_trace(n, _phases(ta, name), seed=seed)
    ref = ra.build_open_loop_trace(n, _phases(ra, name), seed=seed)
    if slos:
        attach_slos(tr, seed=seed)
        ref_attach_slos(ref, seed=seed)
    return tr, ref


# ---------------------------------------------------------------------------
# copied numpy modules: bit-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(PHASES))
def test_open_loop_trace_bit_equal(name):
    got, want = _traces(name, 90, 4, slos=False)
    for f in TRACE_FIELDS:
        _bit_equal(getattr(got, f), getattr(want, f))
    for r, w in zip(got.requests, want.requests):
        for f in dataclasses.fields(w):
            assert getattr(r, f.name) == getattr(w, f.name), f.name
    assert got.has_arrivals and not got.has_slos


def test_arrival_processes_bit_equal():
    _bit_equal(ta.poisson_arrivals(500, 5.0, seed=3),
               ra.poisson_arrivals(500, 5.0, seed=3))
    _bit_equal(ta.onoff_arrivals(300, 20.0, 0.5, 5.0, 5.0, seed=2),
               ra.onoff_arrivals(300, 20.0, 0.5, 5.0, 5.0, seed=2))
    for got, want in zip(ta.mmpp_arrivals(400, _phases(ta, "mmpp"), seed=1),
                         ra.mmpp_arrivals(400, _phases(ra, "mmpp"), seed=1)):
        _bit_equal(got, want)
    req = build_trace(4, seed=0).requests[1]
    from repro.workload.trace import build_trace as ref_build_trace
    ref_req = ref_build_trace(4, seed=0).requests[1]
    for scale in (1.0, 0.4, 1.8, 3.0):
        assert (dataclasses.asdict(ta._scale_request(req, scale))
                == dataclasses.asdict(ra._scale_request(ref_req, scale)))
    with pytest.raises(AssertionError):
        ta.PhaseSpec(rate=1.0, duration=1.0, mix=(0.5, 0.5, 0.5, 0.5))


def _monitor_events(seed, n=400):
    """A seeded sequence of monitor events over 4 nodes."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(0.7))
        node = int(rng.integers(0, 4))
        kind = rng.choice(["dispatch", "dispatch", "complete", "complete",
                           "failure", "heartbeat", "advance", "down",
                           "sweep", "reset"],
                          p=[.22, .1, .22, .1, .12, .1, .05, .04, .03, .02])
        lat = float(rng.choice([0.0, rng.uniform(0.1, 2.0),
                                rng.uniform(3.0, 9.0)]))
        yield str(kind), node, t, lat


def _apply(mon, event):
    kind, node, t, lat = event
    {"dispatch": lambda: mon.on_dispatch(node),
     "complete": lambda: mon.on_complete(node, lat),
     "failure": lambda: mon.on_failure(node),
     "heartbeat": lambda: mon.heartbeat(node, t),
     "advance": lambda: mon.advance(t),
     "down": lambda: mon.mark_down(node),
     "sweep": lambda: mon.sweep(t),
     "reset": lambda: mon.reset_breaker(node)}[kind]()


def _monitor_state(mon):
    fields = [f.name for f in dataclasses.fields(NodeStats)]
    return ([[getattr(mon.stats[j], f) for f in fields]
             for j in sorted(mon.stats)],
            mon.queue_lengths(), mon.healthy_mask(), mon.breaker_states(),
            mon.drift_score(), np.asarray(mon.breaker_opens).tolist(),
            mon.now)


@pytest.mark.parametrize("breaker", [None, 0.5])
def test_monitor_state_equals_reference(breaker):
    kw = dict(heartbeat_timeout=6.0, now=1.0, breaker_threshold=breaker,
              breaker_cooldown=4.0)
    mon, ref = ClusterMonitor(4, **kw), RefMonitor(4, **kw)
    drifted = False
    for i, ev in enumerate(_monitor_events(7 if breaker else 8)):
        _apply(mon, ev)
        _apply(ref, ev)
        assert _monitor_state(mon) == _monitor_state(ref), (i, ev)
        drifted |= mon.drift_score() > 0.25
        if i % 97 == 96:
            mon.rebaseline_drift()
            ref.rebaseline_drift()
    assert drifted                      # the sequence exercises the sensor
    assert (int(np.sum(mon.breaker_opens)) > 0) == (breaker is not None)


# ---------------------------------------------------------------------------
# the open mode and bucketing
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _evaluators(name, n, seed, bucket=None):
    tr, ref_tr = _traces(name, n, seed)
    return (tf.TraceEvaluator(tr, paper_testbed(), tf.EvalConfig(mode="open"),
                              bucket=bucket, device="cpu"),
            rf.TraceEvaluator(ref_tr, ref_testbed(),
                              rf.EvalConfig(mode="open"), bucket=bucket))


def _thresholds(n=24, seed=0):
    rng = np.random.default_rng(seed)
    g = BOUNDS_LO + rng.random((n, 6)).astype(np.float32) * (BOUNDS_HI
                                                             - BOUNDS_LO)
    g[0] = PAPER_DEFAULTS
    return g.astype(np.float32)


def _check_rows(got, want, n=None):
    sl = slice(None, n)
    np.testing.assert_array_equal(got.assign.numpy(),
                                  np.asarray(want.assign)[..., sl])
    for f in ("q", "cost", "rt", "ttft", "tpot"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f))[..., sl],
                                   rtol=RTOL, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.violation.numpy(),
                               np.asarray(want.violation), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["storm", "mmpp"])
def test_open_mode_matches_reference(name):
    """Threshold genomes and random assignments under open-loop arrivals:
    exact assignments, rows within rtol 1e-5, the QoE objectives too."""
    ev, ref = _evaluators(name, 80, 1)
    G = _thresholds()
    _check_rows(ev.run_population("threshold", G),
                jax.vmap(lambda g: ref.run_policy("threshold", g))(
                    jnp.asarray(G)))
    F, viol = ev.make_fitness("threshold", "qoe")(torch.from_numpy(G))
    F_ref, viol_ref = ref.make_fitness("threshold", "qoe")(
        jnp.asarray(G), jax.random.key(0))
    np.testing.assert_allclose(F.numpy(), np.asarray(F_ref), rtol=RTOL)
    np.testing.assert_allclose(viol.numpy(), np.asarray(viol_ref), rtol=RTOL,
                               atol=1e-6)
    A = np.random.default_rng(2).integers(0, 10, (8, 80)).astype(np.int32)
    _check_rows(ev.run_population("direct", A),
                jax.vmap(lambda a: ref.run_policy("direct", a))(
                    jnp.asarray(A)))


def test_bucket_arithmetic_and_pad_tables_match_reference():
    for n in (1, 2, 3, 60, 64, 65, 129, 256):
        assert tf.next_pow2(n) == rf.next_pow2(n)
        assert tf.bucket_size(n, "pow2") == rf.bucket_size(n, "pow2")
    with pytest.raises(ValueError, match="pow2"):
        tf.bucket_size(60, 32)
    ev, ref = _evaluators("storm", 40, 3)
    got = tf.pad_tables(ev.tables, 64)
    want = rf.pad_tables(ref.tables, 64)
    for f in tf.EvalTables._fields:
        _bit_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert tf.pad_tables(ev.tables, 40) is ev.tables


@pytest.mark.parametrize("policy", ["threshold", "slo"])
def test_padded_runs_equal_unpadded(policy):
    """60 rows padded to 64: the per-request rows and assignments bit for
    bit; the sums (violation, objectives) within 1e-6 relative, since a sum
    over 64 rows may take another tree than over 60; padded rows hold zeros
    and assign -1."""
    plain, _ = _evaluators("storm", 60, 5)
    padded, _ = _evaluators("storm", 60, 5, "pow2")
    assert (plain.n_padded, padded.n_valid, padded.n_padded) == (60, 60, 64)
    G = (_thresholds(12) if policy == "threshold" else
         np.stack([SLO_DEFAULTS, [0.5, 0.0], [1.1, 20.0], [0.3, 7.0]])
         .astype(np.float32))
    a, b = plain.run_population(policy, G), padded.run_population(policy, G)
    for f in ("q", "cost", "rt", "assign", "ttft", "tpot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    rel = lambda x, y: float(((x - y).abs()  # noqa: E731
                              / x.abs().clamp(min=1e-30)).max())
    assert rel(a.violation, b.violation) <= 1e-6
    full = padded._run(policy, torch.from_numpy(G))
    assert bool((full.assign[:, 60:] == -1).all())
    for f in ("q", "cost", "rt", "ttft", "tpot"):
        assert not getattr(full, f)[:, 60:].any()
    Fa, va = plain.make_fitness(policy, "qoe")(torch.from_numpy(G))
    Fb, vb = padded.make_fitness(policy, "qoe")(torch.from_numpy(G))
    assert rel(Fa, Fb) <= 1e-6, f"largest relative difference {rel(Fa, Fb)}"
    assert rel(va, vb) <= 1e-6


def test_masked_rows_move_no_state():
    """Rows masked out anywhere in the trace (not only a padded tail) leave
    the slots, the clients and the policy state as they were, exactly as
    the reference's scan does: the same assignments as the reference with
    the same mask, zeros and -1 on the masked rows."""
    ev, ref = _evaluators("storm", 48, 6)
    mask = np.ones(48, bool)
    mask[[3, 10, 11, 30, 47]] = False
    tables = ev.tables._replace(valid=torch.from_numpy(mask))
    ref_tables = ref.tables._replace(valid=jnp.asarray(mask))
    G = _thresholds(8, 4)
    for mode, conc in (("open", 1), ("queued", 4), ("eq5", 1)):
        cfg = tf.EvalConfig(mode=mode, concurrency=conc)
        got = tf._run_trace(torch.from_numpy(G), "threshold", tables,
                            ev.arrays, cfg, ev.n_slots)
        want = jax.vmap(lambda g: rf._run_trace(
            g, "threshold", ref_tables, ref.arrays,
            rf.EvalConfig(mode=mode, concurrency=conc), ref.n_slots))(
                jnp.asarray(G))
        _check_rows(got, want)
        assert bool((got.assign[:, ~mask] == -1).all())
        assert not got.rt[:, ~mask].any()


# ---------------------------------------------------------------------------
# NSGA-II warm start
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["threshold", "slo"])
def test_from_policy_matches_reference(policy):
    got = tn.NSGA2Config.from_policy(policy, pop_size=12, n_generations=3)
    want = rn.NSGA2Config.from_policy(policy, pop_size=12, n_generations=3)
    for f in ("pop_size", "n_generations", "genome", "n_choices",
              "crossover_prob", "mutation_prob"):
        assert getattr(got, f) == getattr(want, f), f
    _bit_equal(got.lo, np.asarray(want.lo))
    _bit_equal(got.hi, np.asarray(want.hi))
    assert got.n_genes == want.n_genes
    disc = tn.NSGA2Config.from_policy("direct", pop_size=4, n_choices=10,
                                      genome_length=7)
    assert disc.genome == "discrete" and disc.n_genes == 7


@pytest.mark.parametrize("genome", ["continuous", "discrete"])
def test_archive_init_matches_reference(genome):
    """The archive's rows seed the population exactly as the reference's
    (clipped into the bounds); the rest is the default random init."""
    if genome == "continuous":
        kw = dict(lo=np.zeros(5, np.float32), hi=np.ones(5, np.float32))
        arch = np.linspace(-0.5, 1.5, 20, dtype=np.float32).reshape(4, 5)
        ref_kw = dict(lo=jnp.zeros(5), hi=jnp.ones(5))
    else:
        kw = ref_kw = dict(genome="discrete", n_choices=10, genome_length=5)
        arch = np.arange(20, dtype=np.int32).reshape(4, 5) % 10
    cfg = tn.NSGA2Config(pop_size=12, n_generations=1, **kw)
    ref_cfg = rn.NSGA2Config(pop_size=12, n_generations=1, **ref_kw)
    pop = tn.archive_init(arch, cfg)(torch.Generator().manual_seed(0))
    ref_pop = np.asarray(rn.archive_init(jnp.asarray(arch), ref_cfg)(
        jax.random.key(0)))
    assert pop.shape == ref_pop.shape == (12, 5)
    assert pop.numpy().dtype == ref_pop.dtype
    _bit_equal(pop[:4].numpy(), ref_pop[:4])
    rest = pop[4:].numpy()
    assert (rest >= 0).all() and (rest <= (1 if genome == "continuous"
                                           else 9)).all()
    assert not np.array_equal(rest, ref_pop[4:])     # drawn, not copied
    # more archive rows than the population: the first pop_size
    big = tn.archive_init(np.tile(arch, (4, 1)), cfg)(torch.Generator())
    _bit_equal(big.numpy(), np.asarray(rn.archive_init(
        jnp.tile(jnp.asarray(arch), (4, 1)), ref_cfg)(jax.random.key(1))))


# ---------------------------------------------------------------------------
# the runtime router
# ---------------------------------------------------------------------------
def _routers(mode):
    genome = PAPER_DEFAULTS if mode == "threshold" else SLO_DEFAULTS
    return (RequestRouter(paper_testbed(), params=genome, mode=mode,
                          device="cpu"),
            RefRouter(ref_testbed(), params=genome, mode=mode))


def _drive(router, trace, record=False):
    """Route every request of ``trace`` with monitor traffic: dispatches,
    completions four requests later, the cloud down for a stretch and an
    edge node down for another, explicit deadlines on every third request,
    a backup asked on every fifth. Returns the decisions and, per step,
    ``should_reoptimize``."""
    mon = router.monitor
    decisions, triggers, inflight = [], [], []
    for i, req in enumerate(trace.requests):
        if i == 60:
            mon.mark_down(0)
        if i == 110:
            mon.heartbeat(0, now=float(i))
            mon.mark_down(2)
        if i == 170:
            mon.heartbeat(2, now=float(i))
        kw = {}
        if i % 3 == 0:
            kw = dict(ttft_deadline=float(trace.ttft_deadline[i]),
                      tpot_deadline=float(trace.tpot_deadline[i]))
        d = router.route(req, want_backup=i % 5 == 0, **kw)
        mon.on_dispatch(d.node)
        inflight.append(d.node)
        if len(inflight) > 4:
            # latencies that step up after request 120: drift
            mon.on_complete(inflight.pop(0), 1.0 + (i > 120) * 4.0
                            + (i % 7) * 0.1)
        decisions.append(d)
        if record:
            router.record(req, d, quality=0.5, cost=d.est_cost, rt=1.0,
                          now=float(trace.arrival_time[i]),
                          ttft_deadline=float(trace.ttft_deadline[i]),
                          tpot_deadline=float(trace.tpot_deadline[i]))
            triggers.append(router.should_reoptimize(min_history=32,
                                                     min_new=16))
    return decisions, triggers


@pytest.mark.parametrize("mode", ["threshold", "slo"])
def test_route_matches_reference_router(mode):
    tr, ref_tr = _traces("mmpp", 220, 9)
    r, ref = _routers(mode)
    got, trig = _drive(r, tr, record=True)
    want, ref_trig = _drive(ref, ref_tr, record=True)
    assert len(got) == 220
    failovers = 0
    for i, (d, w) in enumerate(zip(got, want)):
        for f in ("pair", "node", "model", "go_edge", "features",
                  "backup_pair", "prefill_pair", "est_cost", "est_ttft",
                  "est_tpot", "est_quality"):
            assert getattr(d, f) == getattr(w, f), (i, f)
        failovers += 60 <= i < 110 and d.node != 0
    assert failovers == 50              # the cloud was down: none went there
    assert trig == ref_trig and any(trig) and not all(trig)
    assert _monitor_state(r.monitor) == _monitor_state(ref.monitor)
    assert r.history_size == ref.history_size == 220


def _replay_evolve_scan(self, generator, n_generations=None, archive=None):
    """``NSGA2.evolve_scan`` on the reference's draws: the initial
    population of ``_init_core`` and every generation's draws rebuilt from
    ``jax.random.key(seed)``'s splits, ``seed`` being the generator's."""
    cfg = self.config
    P, D = cfg.pop_size, cfg.n_genes
    lo, hi = jnp.asarray(cfg.lo), jnp.asarray(cfg.hi)
    k_pop, _, key = jax.random.split(
        jax.random.key(generator.initial_seed()), 3)
    g = lo + jax.random.uniform(k_pop, (P, D)) * (hi - lo)
    if archive is not None:
        n = min(archive.shape[0], P)
        g = g.at[:n].set(jnp.clip(jnp.asarray(archive)[:n].astype(g.dtype),
                                  lo, hi))
    state = self.init(generator, archive=torch.from_numpy(np.array(g)))
    for _ in range(n_generations):
        draws = _reference_draws(key, cfg)[0]
        key = jax.random.split(key, 5)[0]
        state = self.step(state, draws)
    return state


@pytest.mark.parametrize("mode", ["threshold", "slo"])
def test_refit_on_reference_draws_installs_reference_genome(mode,
                                                            monkeypatch):
    """Two re-fits in a row (the second warm-started from the first's
    archive) over a recorded open-loop window padded from 40 to 64 rows,
    QoE objectives: the port's genome and archive equal the reference
    router's."""
    monkeypatch.setattr(tn.NSGA2, "evolve_scan", _replay_evolve_scan)
    tr, ref_tr = _traces("storm", 40, 2)
    r, ref = _routers(mode)
    _drive(r, tr, record=True)
    _drive(ref, ref_tr, record=True)
    kw = dict(force=True, window=40, generations=3, pop_size=8)
    for seed in (0, 1):
        got = r.maybe_reoptimize(seed=seed, **kw)
        want = ref.maybe_reoptimize(seed=seed, **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(r._archive, np.asarray(ref._archive),
                                   rtol=1e-6)
        np.testing.assert_array_equal(r.params, got)
    assert r._last_reopt_at == ref._last_reopt_at == 40
    assert r.monitor.drift_score() == ref.monitor.drift_score() == 0.0
    # the window the re-fit scored: open loop, deadlines, recorded features
    trace = r.window_trace(40)
    assert trace.has_arrivals and trace.has_slos
    np.testing.assert_array_equal(trace.complexity, tr.complexity)


def test_router_refuses_what_item_9c_brings():
    """Every runtime policy drives the router, with and without the
    learned estimators; ``direct`` and unknown names still raise, and the
    audit log (item 11) raises naming its item."""
    from repro_torch.core.policies import runtime_policies
    assert len(runtime_policies()) == 8
    for mode in runtime_policies():
        for learned in (False, True):
            r = RequestRouter(paper_testbed(), mode=mode, learned=learned,
                              device="cpu")
            assert r.mode == mode and r.learned == learned
            assert (r.monitor.estimator is not None) == learned
    with pytest.raises(NotImplementedError, match="item 11"):
        RequestRouter(paper_testbed(), audit=object(), device="cpu")
    with pytest.raises(ValueError, match="registered policies"):
        RequestRouter(paper_testbed(), mode="nope", device="cpu")
    with pytest.raises(ValueError, match="per-request"):
        RequestRouter(paper_testbed(), mode="direct", device="cpu")
    r = RequestRouter(paper_testbed(), device="cpu")
    assert r.maybe_reoptimize(force=True) is None       # no history yet
    assert r.window_trace() is None


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def test_online_burst_scenario_windows_match_reference():
    """``run_scenario`` on the CPU at the reference's sizes: every window
    the loop served, under the static, adaptive and cloud-only policies,
    gives the reference evaluator's assignments exactly on the reference's
    own window trace; the adaptive genome moves after the re-fits."""
    res = online.run_scenario("burst", online.SCENARIOS["burst"],
                              device="cpu")
    assert len(res.windows) == online.N_WINDOWS
    for k, w in enumerate(res.windows):
        ph = ra.PhaseSpec(**dataclasses.asdict(online.SCENARIOS["burst"][k]))
        ref_tr = ref_attach_slos(ra.build_open_loop_trace(
            online.WINDOW_REQUESTS, (ph,), seed=k), tightness=1.0, seed=k)
        ref = rf.TraceEvaluator(ref_tr, ref_testbed(),
                                rf.EvalConfig(mode="open"))
        for s in ("static", "adaptive"):
            _check_rows(w.results[s], ref.run_thresholds(
                jnp.asarray(w.genomes[s])))
        cloud = baselines.cloud_only(w.trace, paper_testbed())
        _check_rows(w.results["cloud_only"],
                    ref.run_assignment(jnp.asarray(cloud)))
    assert not np.array_equal(res.windows[-1].genomes["adaptive"],
                              res.windows[0].genomes["adaptive"])
    assert set(res.summary) == set(online.STRATEGIES)
    assert all(np.isfinite(list(dataclasses.asdict(s).values())).all()
               for s in res.summary.values())
    assert len(res.rows) == 3 * online.N_WINDOWS + 3
