"""Parity of the port's routing-policy registry with the JAX package's:
every registered policy's batched ``decide_torch`` equals the reference's
``decide_jnp`` and the port's ``decide_py`` on 400 seeded inputs per
policy and testbed (dead-node sentinels, infinite, infeasible and
near-tie deadlines, non-zero hit fractions and KV bytes, learned quality
and uncertainty rows, genome-own rows of shape (P, n_pairs)); the budget
ledger's update twins agree over sequences that cross windows; the
registry equals the reference's. The jnp twins run op by op (vmapped, not
jitted), as the reference's own tests run them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.spec import disagg_testbed as ref_disagg_testbed
from repro.cluster.spec import paper_testbed as ref_paper_testbed
from repro.core.policies import PolicyInputs as RefInputs
from repro.core.policies import get_policy as ref_get_policy
from repro.core.policies.p2c_hedge import _mix32_py as ref_mix32
from repro_torch.cluster.spec import (ClusterArrays, disagg_testbed,
                                      paper_testbed)
from repro_torch.core.fitness import (DEAD_QUEUE, DEAD_UP,
                                      request_pair_estimates)
from repro_torch.core.policies import (PolicyInputs, get_policy,
                                       list_policies)
from repro_torch.core.policies.budget import WINDOW_S
from repro_torch.core.policies.p2c_hedge import candidates

P, N_REQ = 8, 50
TESTBEDS = {"paper": (paper_testbed, ref_paper_testbed),
            "disagg": (disagg_testbed, ref_disagg_testbed)}


def _genomes(pol, rng, n_pairs, n_req):
    spec = pol.genome_spec
    if spec.per_request:
        return rng.integers(0, n_pairs, (P, n_req)).astype(np.int32)
    G = (spec.lo + rng.random((P, spec.length)) * (spec.hi - spec.lo))
    G = G.astype(np.float32)
    G[0] = spec.defaults
    G[1] = spec.lo                      # the corners of the search box
    G[2] = spec.hi
    return G


def _states(pol, rng, now):
    S = np.tile(pol.init_state(), (P, 1)).astype(np.float32)
    if pol.state_size:                  # the budget ledger: this window's
        w = np.floor(now / np.float32(WINDOW_S)).astype(np.float32)
        S[:, 0] = np.where(rng.random(P) < 0.6, w, w - 1)
        S[:, 1] = rng.uniform(0, 0.03, P).astype(np.float32)
    return S


def _inputs(k, rng, arrays):
    """Request ``k``'s inputs: shared scalars and rows, and per genome a
    queue view, decision time and the genome-own rows."""
    n_pairs, n_nodes = arrays.n_pairs, arrays.n_nodes
    est = request_pair_estimates(float(rng.integers(20, 2000)),
                                 float(rng.integers(10, 300)),
                                 float(rng.integers(100, 4000)), arrays)
    queue = rng.integers(0, 12, (P, n_nodes)).astype(np.int64)
    dead = rng.random((P, n_nodes)) < 0.15
    dead[0] = False
    queue[dead] = DEAD_QUEUE
    up = np.where(dead[:, arrays.pair_node], np.float32(DEAD_UP),
                  est["up"]).astype(np.float32)
    d = rng.uniform(-0.5, 2.0, (P, n_nodes)).astype(np.float32)
    prefill = (est["prefill"] * (np.float32(1) + d[:, arrays.pair_node])
               ).astype(np.float32)
    tpot = (est["tpot"] * (np.float32(1) + d[:, arrays.pair_node] / 4)
            ).astype(np.float32)
    hit = rng.uniform(0, 1, (P, n_pairs)).astype(np.float32)
    hit[rng.random((P, n_pairs)) < 0.4] = 0.0
    kind = k % 5
    if kind == 0:
        ttft, tpot_dl = rng.uniform(0.05, 6.0), rng.uniform(0.03, 0.8)
    elif kind == 1:
        ttft, tpot_dl = 5.0, 0.8
    elif kind == 2:
        ttft, tpot_dl = 1e-4, 1e-4
    elif kind == 3:
        ttft, tpot_dl = np.inf, np.inf
    else:                               # a pair's own estimate: near ties
        p = int(rng.integers(0, n_pairs))
        ttft = float(est["up"][p] + est["prefill"][p])
        tpot_dl = float(est["tpot"][p])
    index = int(rng.integers(0, 2**31)) if k % 3 == 0 else k
    shared = dict(
        index=index, complexity=np.float32(rng.random()),
        pred_category=np.int32(rng.integers(0, 3)),
        pred_conf=np.float32(rng.random()), ttft_deadline=np.float32(ttft),
        tpot_deadline=np.float32(tpot_dl),
        prompt_tokens=np.float32(rng.integers(8, 2000)),
        cost=est["cost"], prompt_cost=est["prompt_cost"],
        kv_bytes=(np.float32(rng.integers(0, 64)) * np.float32(16)
                  * arrays.pair_kv_bytes_per_token).astype(np.float32))
    own = dict(up=up, prefill=prefill, tpot=tpot, hit_frac=hit,
               quality=rng.uniform(0, 1, (P, n_pairs)).astype(np.float32),
               unc=rng.uniform(0, 0.6, (P, n_pairs)).astype(np.float32),
               queue_len=queue,
               now=rng.uniform(0, 200, P).astype(np.float32))
    return shared, own


def _torch_inputs(shared, own):
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    return PolicyInputs(**{k: (v if k == "index" else t(v))
                           for k, v in shared.items()},
                        **{k: t(v) for k, v in own.items()})


def _row_inputs(shared, own, p):
    return PolicyInputs(**shared, **{k: v[p] for k, v in own.items()})


def _jnp_decisions(ref_pol, ref_arrays, G, S, shared, own):
    """The reference's decide_jnp for every genome, vmapped op by op."""
    keys = tuple(own)

    def one(g, s, *rows):
        inp = RefInputs(**{k: jnp.asarray(v) for k, v in shared.items()},
                        **dict(zip(keys, rows)))
        return ref_pol.decide_jnp(g, inp, ref_arrays, s)

    return np.asarray(jax.vmap(one)(jnp.asarray(G), jnp.asarray(S),
                                    *(jnp.asarray(own[k]) for k in keys)))


@pytest.mark.parametrize("testbed", sorted(TESTBEDS))
@pytest.mark.parametrize("policy", list_policies())
def test_decide_twins_agree(policy, testbed):
    """400 inputs (50 requests x 8 genomes): decide_torch (one batched
    call a request) == the reference's decide_jnp == decide_py."""
    make, make_ref = TESTBEDS[testbed]
    arrays = ClusterArrays(**make().arrays_numpy())
    t_arrays = make().to_arrays("cpu")
    ref_arrays = make_ref().to_arrays()
    pol, ref_pol = get_policy(policy), ref_get_policy(policy)
    rng = np.random.default_rng(
        [list_policies().index(policy), sorted(TESTBEDS).index(testbed)])
    n_out = arrays.n_routes if pol.decides == "route" else arrays.n_pairs
    n = 0
    seen = set()
    for k in range(N_REQ):
        shared, own = _inputs(k, rng, arrays)
        if pol.genome_spec.per_request:
            shared["index"] = k         # one gene per request
        G = _genomes(pol, rng, arrays.n_pairs, N_REQ)
        S = _states(pol, rng, own["now"])
        got = pol.decide_torch(torch.from_numpy(G),
                               _torch_inputs(shared, own), t_arrays,
                               torch.from_numpy(S)).numpy()
        jx = _jnp_decisions(ref_pol, ref_arrays, G, S, shared, own)
        for p in range(P):
            py = pol.decide_py(G[p], _row_inputs(shared, own, p), arrays,
                               S[p])
            assert got[p] == jx[p] == py, (k, p, got[p], jx[p], py)
            assert 0 <= py < n_out
            seen.add(py)
            n += 1
    assert n == 400
    # the disaggregated testbed has no edge pair: Algorithm 2 falls back
    assert len(seen) > 1 or (policy, testbed) == ("threshold", "disagg")


def test_budget_ledger_twins_agree_across_windows():
    """Decide and bill in dispatch order over a clock that crosses many
    30-s windows: the batched ledger, the reference's update_jnp and the
    port's update_py stay bit-equal, and so do the decisions."""
    pol, ref_pol = get_policy("budget"), ref_get_policy("budget")
    arrays = ClusterArrays(**paper_testbed().arrays_numpy())
    t_arrays = paper_testbed().to_arrays("cpu")
    ref_arrays = ref_paper_testbed().to_arrays()
    rng = np.random.default_rng(4)
    G = _genomes(pol, rng, arrays.n_pairs, 1)
    G[3] = [0.002, 0.9, 3.0]            # a tight budget exhausts windows
    S = np.tile(pol.init_state(), (P, 1))
    S_ref = [jnp.asarray(s) for s in S]
    S_py = [s.copy() for s in S]
    now = np.zeros(P, np.float32)
    windows = set()
    for k in range(80):
        shared, own = _inputs(k, rng, arrays)
        now = (now + rng.exponential(5.0, P)).astype(np.float32)
        own["now"] = now
        inp = _torch_inputs(shared, own)
        got = pol.decide_torch(torch.from_numpy(G), inp, t_arrays,
                               torch.from_numpy(S))
        # the ledger bills list price, not the realized cost argument
        S_new = pol.update_torch(torch.from_numpy(G), torch.from_numpy(S),
                                 inp, got, torch.zeros(P)).numpy()
        for p in range(P):
            row = _row_inputs(shared, own, p)
            pair = pol.decide_py(G[p], row, arrays, S_py[p])
            assert pair == got[p]
            ref_row = RefInputs(**{f: jnp.asarray(v)
                                   for f, v in row._asdict().items()})
            assert pair == int(ref_pol.decide_jnp(jnp.asarray(G[p]), ref_row,
                                                  ref_arrays, S_ref[p]))
            S_py[p] = pol.update_py(G[p], S_py[p], row, pair, 0.0)
            S_ref[p] = ref_pol.update_jnp(jnp.asarray(G[p]), S_ref[p],
                                          ref_row, jnp.int32(pair),
                                          jnp.float32(0.0))
            np.testing.assert_array_equal(S_new[p], S_py[p])
            assert S_new[p].tobytes() == np.asarray(S_ref[p]).tobytes()
            windows.add(float(S_py[p][0]))
        S = S_new
    assert len(windows) > 10


def test_p2c_candidates_wrap_like_uint32():
    """The candidate pair of request indexes up to 2**31 - 1 (the
    reference's int32 index), through the reference's own hash."""
    for i in (0, 1, 2**16 - 1, 2**24 - 1, 2**24, 2**24 + 1, 2**31 - 1):
        for n in (1, 7, 10, 28):
            assert candidates(i, n) == (ref_mix32(2 * i + 1) % n,
                                        ref_mix32(2 * i + 2) % n)


@pytest.mark.parametrize("policy", list_policies())
def test_registry_entries_equal_reference(policy):
    pol, ref = get_policy(policy), ref_get_policy(policy)
    assert (pol.name, pol.requires, pol.decides, pol.state_size) == (
        ref.name, ref.requires, ref.decides, ref.state_size)
    np.testing.assert_array_equal(pol.init_state(), ref.init_state())
    for f in ("names", "discrete", "per_request", "length"):
        assert getattr(pol.genome_spec, f) == getattr(ref.genome_spec, f)
    for f in ("lo", "hi", "defaults"):
        a, b = getattr(pol.genome_spec, f), getattr(ref.genome_spec, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
