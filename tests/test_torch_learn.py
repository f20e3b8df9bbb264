"""Parity of the port's online estimators with the JAX package's: for both
estimator kinds, ``predict_torch``/``update_torch`` (batched over genomes)
equal ``predict_np``/``update_np`` and the reference's ``_jnp`` twins bit
for bit over 200+ seeded updates, colocated routes (prefill node == decode
node) among them; zero residuals reproduce the static rows bitwise; the
live ``OnlineEstimator`` equals the reference's. The jnp twins run op by op
(not under ``jit``), as the reference's own tests run them: inside a jitted
program XLA on the CPU contracts multiply-add pairs into FMA
instructions. They are slow op by op, so they follow the first
``JNP_GENOMES`` of the batch (2 x 220 updates a kind)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learn import LearnConfig as RefConfig
from repro.learn import OnlineEstimator as RefEstimator
from repro.learn import estimators as re
from repro_torch.learn import LearnConfig, OnlineEstimator
from repro_torch.learn import estimators as te

N_NODES, P = 4, 5
JNP_GENOMES = 2
CONC = np.array([8, 4, 4, 4], np.int32)
PAIR_NODE = np.array([0, 1, 1, 1, 2, 2, 2, 3, 3, 3])


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _steps(seed, n):
    """Seeded observations: a shared category and request features, and
    per genome a queue view (dead-node sentinels included), the two legs'
    nodes (colocated on most steps) and the residual targets."""
    rng = np.random.default_rng(seed)
    for k in range(n):
        queue = rng.integers(0, 10, (P, N_NODES)).astype(np.int32)
        queue[rng.random((P, N_NODES)) < 0.1] = 10**6
        node_q = rng.integers(0, N_NODES, P)
        node_p = np.where(rng.random(P) < 0.6, node_q,
                          rng.integers(0, N_NODES, P))
        ys = [rng.normal(0, 0.8, P).astype(np.float32) for _ in range(3)]
        if k % 7 == 0:
            ys[0][:] = 0.0                  # fault-free latency targets
        yield (int(rng.integers(0, 3)), np.float32(rng.integers(8, 900)),
               np.float32(rng.random()), queue, node_p, node_q, ys)


@pytest.mark.parametrize("kind", ["ewma", "blr"])
def test_predict_and_update_twins_bit_equal(kind):
    cfg, ref_cfg = LearnConfig(kind=kind), RefConfig(kind=kind)
    init = te.init_state(cfg, N_NODES)
    _bit_equal(init, re.init_state(ref_cfg, N_NODES))
    assert te.state_size(cfg, N_NODES) == re.state_size(ref_cfg, N_NODES)
    state = torch.from_numpy(np.tile(init, (P, 1)))
    np_states = [init.copy() for _ in range(P)]
    jnp_states = [jnp.asarray(init) for _ in range(JNP_GENOMES)]
    conc_t = torch.from_numpy(CONC)
    n = colocated = 0
    for cat, pt, cx, queue, node_p, node_q, ys in _steps(3, 220):
        x1, x2, x3 = te.features(torch, torch.tensor(pt), torch.tensor(cx),
                                 torch.from_numpy(queue), conc_t)
        pred = te.predict_torch(cfg, state, N_NODES, cat, x1, x2, x3)
        for p in range(P):
            rx1, rx2, rx3 = re.features(np, pt, cx, queue[p], CONC)
            _bit_equal(x1.numpy(), rx1)
            _bit_equal(x3[p].numpy(), rx3)
            want = re.predict_np(ref_cfg, np_states[p], N_NODES, cat, rx1,
                                 rx2, rx3)
            mine = te.predict_np(cfg, np_states[p], N_NODES, cat, rx1, rx2,
                                 rx3)
            for a, b, d in zip(pred, want, mine):
                _bit_equal(a[p].numpy(), b)
                _bit_equal(d, b)
            if p < JNP_GENOMES:
                jx = re.predict_jnp(ref_cfg, jnp_states[p], N_NODES,
                                    jnp.int32(cat), jnp.float32(rx1),
                                    jnp.float32(rx2), jnp.asarray(rx3))
                for a, c in zip(pred, jx):
                    _bit_equal(a[p].numpy(), c)
        state = te.update_torch(cfg, state, N_NODES, cat,
                                torch.from_numpy(node_p),
                                torch.from_numpy(node_q), x1, x2, x3,
                                *(torch.from_numpy(y) for y in ys))
        for p in range(P):
            rx1, rx2, rx3 = re.features(np, pt, cx, queue[p], CONC)
            args = (N_NODES, cat, int(node_p[p]), int(node_q[p]), rx1, rx2,
                    rx3, ys[0][p], ys[1][p], ys[2][p])
            np_states[p] = re.update_np(ref_cfg, np_states[p], *args)
            _bit_equal(state[p].numpy(), np_states[p])
            if p < JNP_GENOMES:
                jnp_states[p] = re.update_jnp(
                    ref_cfg, jnp_states[p], N_NODES, jnp.int32(cat),
                    jnp.int32(node_p[p]), jnp.int32(node_q[p]),
                    jnp.float32(rx1), jnp.float32(rx2), jnp.asarray(rx3),
                    jnp.float32(ys[0][p]), jnp.float32(ys[1][p]),
                    jnp.float32(ys[2][p]))
                _bit_equal(state[p].numpy(), np.asarray(jnp_states[p]))
            colocated += int(node_p[p] == node_q[p])
            n += 1
    assert n >= 200 * P and colocated > n // 3
    assert not np.array_equal(np_states[0], init)


@pytest.mark.parametrize("kind", ["ewma", "blr"])
def test_numpy_update_copy_equals_reference(kind):
    cfg, ref_cfg = LearnConfig(kind=kind), RefConfig(kind=kind)
    s = r = te.init_state(cfg, N_NODES)
    for cat, pt, cx, queue, node_p, node_q, ys in _steps(5, 60):
        x1, x2, x3 = te.features(np, pt, cx, queue[0], CONC)
        args = (N_NODES, cat, int(node_p[0]), int(node_q[0]), x1, x2, x3,
                ys[0][0], ys[1][0], ys[2][0])
        s = te.update_np(cfg, s, *args)
        r = re.update_np(ref_cfg, r, *args)
        _bit_equal(s, r)


@pytest.mark.parametrize("kind", ["ewma", "blr"])
def test_zero_residuals_reproduce_static_rows(kind):
    cfg = LearnConfig(kind=kind)
    rng = np.random.default_rng(1)
    prefill = rng.uniform(0.01, 3, (P, 10)).astype(np.float32)
    tpot = rng.uniform(0.03, 0.3, 10).astype(np.float32)
    quality = rng.uniform(0, 1, 10).astype(np.float32)
    state = torch.from_numpy(np.tile(te.init_state(cfg, N_NODES), (P, 1)))
    queue = torch.from_numpy(rng.integers(0, 9, (P, N_NODES)))
    x1, x2, x3 = te.features(torch, torch.tensor(np.float32(300)),
                             torch.tensor(np.float32(0.4)), queue,
                             torch.from_numpy(CONC))
    d_p, d_t, d_q, unc = te.predict_torch(cfg, state, N_NODES, 1, x1, x2, x3)
    assert not d_p.any() and not d_t.any() and not d_q.any()
    pc, tc, qc, uc = te.corrected_rows(
        torch, torch.from_numpy(prefill), torch.from_numpy(tpot),
        torch.from_numpy(quality), d_p, d_t, d_q, unc,
        torch.from_numpy(PAIR_NODE))
    _bit_equal(pc.numpy(), prefill)
    _bit_equal(tc.numpy(), np.broadcast_to(tpot, (P, 10)))
    _bit_equal(qc.numpy(), np.broadcast_to(quality, (P, 10)))
    assert uc.shape == (P, 10)
    # observations of a fault-free run are exact zeros
    y_p, y_t, y_q = te.observations(torch, torch.from_numpy(prefill[:, 0]),
                                    1.0, torch.from_numpy(tpot[:P]), 1.0,
                                    torch.tensor(0.5), torch.tensor(0.5))
    assert not y_p.any() and not y_t.any() and not y_q.any()
    got = te.observations(torch, torch.from_numpy(prefill[:, 0]),
                          torch.full((P,), 3.0), torch.from_numpy(tpot[:P]),
                          torch.full((P,), 2.0), torch.tensor(0.7),
                          torch.tensor(0.5))
    for p in range(P):
        want = re.observations(np, prefill[p, 0], np.float32(3.0), tpot[p],
                               np.float32(2.0), np.float32(0.7),
                               np.float32(0.5))
        for a, b in zip(got, want):
            _bit_equal(a.numpy()[p] if a.dim() else a.numpy(), b)


@pytest.mark.parametrize("kind", ["ewma", "blr"])
def test_online_estimator_equals_reference(kind):
    est = OnlineEstimator(LearnConfig(kind=kind), N_NODES, node_conc=CONC)
    ref = RefEstimator(RefConfig(kind=kind), N_NODES, node_conc=CONC)
    rng = np.random.default_rng(9)
    for _ in range(120):
        queue = rng.integers(0, 7, N_NODES)
        cat, pt, cx = int(rng.integers(0, 3)), int(rng.integers(8, 900)), \
            float(rng.random())
        for a, b in zip(est.predict(cat, pt, cx, queue, CONC),
                        ref.predict(cat, pt, cx, queue, CONC)):
            _bit_equal(a, b)
        exp, real = float(rng.uniform(0, 2)), float(rng.uniform(0, 4))
        assert OnlineEstimator.ratio(exp, real) == RefEstimator.ratio(exp,
                                                                      real)
        args = (cat, int(rng.integers(0, N_NODES)),
                int(rng.integers(0, N_NODES)), pt, cx, queue, CONC,
                OnlineEstimator.ratio(exp, real), float(rng.normal()),
                float(rng.normal(0, 0.1)))
        est.observe(*args)
        ref.observe(*args)
        _bit_equal(est.state, ref.state)
    assert est.n_obs == ref.n_obs == 120
    assert OnlineEstimator.ratio(0.0, 3.0) == 0.0
    with pytest.raises(AssertionError):
        OnlineEstimator(LearnConfig(), 0)
