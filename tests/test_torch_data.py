"""Parity of the port's host data with the JAX package's: the trace, the
cluster arrays and the evaluator tables must be bit-equal, the converters
must carry them across unchanged, and the config copies must equal the
reference's."""
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
from repro_torch.configs import ARCHS
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


def test_open_loop_trace_from_requests_bit_equal():
    """``trace_from_requests(arrival_time=)`` and the session arrays: the
    same requests with session identity and arrival times give the same
    trace, field for field."""
    from repro.workload.datasets import generate as ref_generate
    from repro.workload.trace import trace_from_requests as ref_tfr
    from repro_torch.workload.datasets import generate
    from repro_torch.workload.trace import trace_from_requests
    mine, ref = generate("gsm8k", 9, seed=2), ref_generate("gsm8k", 9, seed=2)
    for i in range(0, 9, 2):
        kw = dict(session_id=i // 3, turn=i % 3, sys_id=i % 2,
                  sys_tokens=10 * i)
        mine[i] = dataclasses.replace(mine[i], **kw)
        ref[i] = dataclasses.replace(ref[i], **kw)
    times = np.cumsum(np.random.default_rng(0).exponential(1.0, 9))
    got = trace_from_requests(mine, seed=4, arrival_time=times)
    want = ref_tfr(ref, seed=4, arrival_time=times)
    for f in TRACE_FIELDS + ("arrival_time", "group_id", "sys_id",
                             "sys_tokens"):
        _bit_equal(getattr(got, f), getattr(want, f))
    closed = trace_from_requests(generate("squad", 4))
    assert closed.group_id is None and closed.arrival_time is None
    with pytest.raises(AssertionError):
        trace_from_requests(mine, arrival_time=times[::-1])


@pytest.mark.parametrize("module", ARCHS)
def test_config_copies_equal_the_reference(module):
    """All ten config modules: ``config()`` and ``smoke()`` equal the
    reference's field by field (sub-configs included), with the same
    derived sizes, blocks, parameter accounting and FLOPs; the registry's
    ids and aliases are the reference's."""
    from repro.configs import ALIASES as REF_ALIASES
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import all_ids as ref_all_ids
    from repro.configs import get as ref_get
    from repro_torch.configs import ALIASES, all_ids, get
    assert ARCHS == REF_ARCHS and ALIASES == REF_ALIASES
    assert all_ids() == ref_all_ids()
    for fn in ("config", "smoke"):
        a = getattr(get(module), fn)()
        b = getattr(ref_get(module), fn)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_counts() == b.param_counts()
        assert (a.model_flops_per_token(False)
                == b.model_flops_per_token(False))
        assert (a.hd, a.q_dim, a.kv_dim, a.n_periods) == \
            (b.hd, b.q_dim, b.kv_dim, b.n_periods)
        assert [a.block_at(i) for i in range(a.n_layers)] == \
            [b.block_at(i) for i in range(b.n_layers)]
    assert get(module).NAME == ref_get(module).NAME


@pytest.mark.parametrize("vocab,seq_len,batch,seed,chains,branch", [
    (128, 16, 4, 0, 8, 32), (151936, 128, 8, 0, 8, 32),
    (64, 33, 6, 7, 2, 4), (512, 32, 4, 3, 1, 4)])
def test_data_pipeline_copy_bit_equal(vocab, seq_len, batch, seed, chains,
                                      branch):
    """``data/pipeline.py`` is a copy: the same successor tables, rows,
    batches, host shards and prefetching iterator as the original's."""
    from repro.data import DataConfig as RefDataConfig
    from repro.data import SyntheticLMData as RefData
    from repro_torch.data import DataConfig, SyntheticLMData
    kw = dict(vocab=vocab, seq_len=seq_len, global_batch=batch, seed=seed,
              n_chains=chains, branch=branch)
    got, want = SyntheticLMData(DataConfig(**kw)), RefData(RefDataConfig(**kw))
    _bit_equal(got._succ, want._succ)
    for step in (0, 1, 17):
        for k in ("tokens", "labels"):
            _bit_equal(got.batch(step)[k], want.batch(step)[k])
    h = [SyntheticLMData(DataConfig(**kw), host_index=i, n_hosts=2)
         for i in (0, 1)]
    hr = [RefData(RefDataConfig(**kw), host_index=i, n_hosts=2)
          for i in (0, 1)]
    for a, b in zip(h, hr):
        _bit_equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    it, rit = got.iterator(start_step=3), want.iterator(start_step=3)
    for _ in range(3):
        a, b = next(it), next(rit)
        _bit_equal(a["tokens"], b["tokens"])
        _bit_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("concurrency", [1, 4])
def test_simulator_copy_bit_equal(concurrency):
    """``cluster/simulator.py`` is a copy: on the quickstart trace every
    field of both oracles' ``SimResult`` equals the original's bit for bit
    (its other modes: ``tests/test_torch_simulator.py``)."""
    from repro.cluster.simulator import ClusterSimulator as RefSim
    from repro_torch.cluster.simulator import ClusterSimulator
    tr, ref_tr = _traces(500, 0)
    assign = baselines.round_robin(tr, paper_testbed())
    sim, ref = ClusterSimulator(tr, paper_testbed()), RefSim(ref_tr,
                                                             ref_testbed())
    for fn in ("run", "run_event_heap"):
        got = getattr(sim, fn)(assign, concurrency=concurrency)
        want = getattr(ref, fn)(assign, concurrency=concurrency)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if b is None:
                assert a is None, f.name
            else:
                _bit_equal(a, b)
