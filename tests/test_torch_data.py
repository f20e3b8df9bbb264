"""Parity of the port's host data with the JAX package's: the trace, the
cluster arrays and the evaluator tables must be bit-equal, and the
converters must carry them across unchanged."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import baselines as ref_baselines
from repro.core.fitness import build_tables as ref_build_tables
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch import convert
from repro_torch.cluster.spec import ClusterArrays, paper_testbed
from repro_torch.core import baselines
from repro_torch.core.fitness import EvalTables, build_tables
from repro_torch.workload.trace import build_trace

TRACE_FIELDS = ("task", "pred_category", "pred_conf", "complexity",
                "prompt_tokens", "resp_tokens_mean", "difficulty",
                "query_bytes")


@functools.lru_cache(maxsize=None)
def _traces(n, seed):
    return build_trace(n, seed=seed), ref_build_trace(n, seed=seed)


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,seed", [(500, 0), (37, 3)])
def test_trace_bit_equal(n, seed):
    got, want = _traces(n, seed)
    assert got.n_requests == want.n_requests == n
    for f in TRACE_FIELDS:
        _bit_equal(getattr(got, f), getattr(want, f))
    for r, w in zip(got.requests, want.requests):
        for f in dataclasses.fields(r):
            assert getattr(r, f.name) == getattr(w, f.name), f.name


def test_cluster_arrays_bit_equal():
    got = paper_testbed().to_arrays("cpu")
    want = ref_testbed().to_arrays().numpy()
    assert isinstance(got, ClusterArrays)
    for f in ClusterArrays._fields:
        _bit_equal(getattr(got, f).numpy(), getattr(want, f))
    assert paper_testbed().describe() == ref_testbed().describe()


@pytest.mark.parametrize("seed", [0, 5])
def test_build_tables_bit_equal(seed):
    tr, ref_tr = _traces(500, 0)
    tables, arrays = build_tables(tr, paper_testbed(), seed=seed,
                                  device="cpu")
    ref_tables, _ = ref_build_tables(ref_tr, ref_testbed(), seed=seed)
    for f in EvalTables._fields:
        _bit_equal(getattr(tables, f).numpy(),
                   np.asarray(getattr(ref_tables, f)))


def test_converters_carry_reference_fields():
    tr, ref_tr = _traces(37, 3)
    ref_tables, ref_arrays = ref_build_tables(ref_tr, ref_testbed())
    t = convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in ref_tables._asdict().items()}, "cpu")
    a = convert.arrays_from_numpy(ref_arrays.numpy()._asdict(), "cpu")
    mine_t, mine_a = build_tables(tr, paper_testbed(), device="cpu")
    for f in EvalTables._fields:
        assert torch.equal(getattr(t, f), getattr(mine_t, f)), f
    for f in ClusterArrays._fields:
        assert torch.equal(getattr(a, f), getattr(mine_a, f)), f
    rng = np.random.default_rng(0)
    d = dict(genomes=rng.random((6, 4)).astype(np.float32),
             F=rng.random((6, 3)).astype(np.float32),
             F_raw=rng.random((6, 3)).astype(np.float32),
             violation=np.zeros(6, np.float32),
             rank=np.arange(6, dtype=np.int32),
             crowd=rng.random(6).astype(np.float32),
             key=np.zeros(2, np.uint32), generation=np.int32(4))
    s = convert.state_from_numpy(d, "cpu")
    assert s.generation == 4
    for f in ("genomes", "F", "F_raw", "violation", "rank", "crowd"):
        _bit_equal(getattr(s, f).numpy(), d[f])


@pytest.mark.parametrize("name", ["cloud_only", "edge_only", "round_robin",
                                  "random_router"])
def test_baselines_equal(name):
    tr, ref_tr = _traces(500, 0)
    got = getattr(baselines, name)(tr, paper_testbed())
    want = getattr(ref_baselines, name)(ref_tr, ref_testbed())
    _bit_equal(got, want)


def test_heuristic_bias_init_equal():
    tr, ref_tr = _traces(37, 3)
    _bit_equal(baselines.heuristic_bias_init(tr, paper_testbed(), 8, seed=2),
               ref_baselines.heuristic_bias_init(ref_tr, ref_testbed(), 8,
                                                 seed=2))
