"""The port's multi-turn session workload held against the reference, and
the session serve driven end to end on the CPU.

``workload.sessions`` is a numpy copy: the same config and seed must give
the same requests, arrival times and trace arrays, field for field and bit
for bit. The session serve (``run_serve(sessions=True)``) must reuse
prefixes on that trace, leak no block, and serve the tokens of the same run
without the prefix cache (f32, where reuse is exact).
"""
import dataclasses

import numpy as np
import pytest

from repro.workload import sessions as rsessions
from repro_torch import serve
from repro_torch.configs import get
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.workload import sessions

TRACE_ARRAYS = ("task", "pred_category", "pred_conf", "complexity",
                "prompt_tokens", "resp_tokens_mean", "difficulty",
                "query_bytes", "arrival_time", "group_id", "sys_id",
                "sys_tokens")
CONFIGS = [{}, dict(n_sessions=5, mean_turns=4.0, n_system_prompts=0),
           dict(n_sessions=9, system_prompt_sentences=2, think_time_s=1.0)]


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_request(r, w):
    for f in dataclasses.fields(w):
        assert getattr(r, f.name) == getattr(w, f.name), f.name


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_session_trace_equal_field_for_field(kw, seed):
    got = sessions.build_session_trace(sessions.SessionConfig(**kw),
                                       seed=seed)
    want = rsessions.build_session_trace(rsessions.SessionConfig(**kw),
                                         seed=seed)
    assert got.n_requests == want.n_requests
    assert got.has_sessions and got.has_arrivals
    for f in TRACE_ARRAYS:
        _bit_equal(getattr(got, f), getattr(want, f))
    for r, w in zip(got.requests, want.requests):
        _same_request(r, w)


def test_session_requests_and_truncation_equal():
    cfg, rcfg = sessions.SessionConfig(), rsessions.SessionConfig()
    got = sessions.session_requests(cfg, seed=1)
    want = rsessions.session_requests(rcfg, seed=1)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, r), (_, w) in zip(got, want):
        _same_request(r, w)
    short = sessions.build_session_trace(cfg, seed=0, n_requests=11)
    rshort = rsessions.build_session_trace(rcfg, seed=0, n_requests=11)
    for f in TRACE_ARRAYS:
        _bit_equal(getattr(short, f), getattr(rshort, f))


def test_default_session_trace_is_the_served_one():
    """The trace ``serve --sessions`` serves: 47 requests of 148–1,007
    words, each later turn's words extending its session's earlier turn."""
    tr = sessions.build_session_trace(sessions.SessionConfig(), seed=0)
    words = [len(r.text.split()) for r in tr.requests]
    assert (tr.n_requests, min(words), max(words), sum(words)) == (
        47, 148, 1007, 16974)
    last = {}
    for r in tr.requests:
        if r.session_id in last:
            assert r.text.startswith(last[r.session_id] + " ")
        last[r.session_id] = r.text
    assert max(w + serve.budget(b) for w, b in zip(
        words, tr.resp_tokens_mean)) <= serve.SESSION_ENGINE.max_seq


def test_session_serve_reuses_prefixes_and_leaks_nothing():
    cfg = dataclasses.replace(get("qwen3-1.7b").smoke(), dtype="float32")
    model = serve.build_model(cfg, "cpu")
    before = (flash_attention.LAUNCHES, decode_attention.LAUNCHES)
    runs = [serve.run_serve(cfg=cfg, model=model, device="cpu",
                            sessions=True, prefix_cache=cache)
            for cache in (True, False)]
    assert (flash_attention.LAUNCHES, decode_attention.LAUNCHES) == before
    cached, plain = runs
    assert sorted(cached.results) == list(range(47))
    for rid, r in cached.results.items():
        assert r["tokens"] == plain.results[rid]["tokens"], rid
        assert len(r["tokens"]) == cached.budgets[rid]
        assert r["prompt_tokens"] == len(cached.prompts[rid])
    st = cached.engine.cache_stats()
    assert st["lookups"] == 47 and st["evictions"] == 0
    assert st["prefill_tokens_total"] == 16974
    assert st["prefill_tokens_run"] < 0.3 * st["prefill_tokens_total"]
    assert sum(r["cached_tokens"] for r in cached.results.values()) == \
        st["hit_tokens"]
    pool = cached.engine.kv.cache.pool
    assert not (pool.ref > 0).any()
    cached.engine.kv.cache.check_invariants()
    assert plain.engine.kv is None
    assert plain.engine.cache_stats()["lookups"] == 0
    assert "prefix cache" in serve.format_run(cached)[-1]
