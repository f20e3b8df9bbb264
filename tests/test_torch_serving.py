"""The port's serving engine held against the reference engine.

With the same weights (the reference's ``lm.init`` carried over by
``convert.lm_params_from_numpy``) and the f32 configs, the port's engine
must emit exactly the reference engine's greedy tokens, with the same QoE
accounting. Within the port (bf16, as served), the engine must agree with
itself: ``step_n`` against ``step``, ragged slots independent, queued
requests admitted. Against teacher forcing (repeated full forward passes,
as ``tests/test_serving.py`` holds the reference), its tokens are exact in
f32 and the teacher-forced maxima up to near-ties in bf16. No kernel
launches on the CPU.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefEngine
from repro.serving.scheduler import ClusterServer
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch import serve
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import lm
from repro_torch.serving import EngineConfig, LLMEngine

NAMES = ("qwen3-1.7b", "stablelm-3b")


@functools.lru_cache(maxsize=None)
def _pair(name: str, dtype: str):
    rcfg = dataclasses.replace(ref_get(name).smoke(), dtype=dtype)
    cfg = dataclasses.replace(get(name).smoke(), dtype=dtype)
    params = rlm.init(jax.random.key(0), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return rcfg, params, cfg, model


def _engine(name, dtype="bfloat16", **kw):
    _, _, cfg, model = _pair(name, dtype)
    return LLMEngine(cfg, model, EngineConfig(**kw), device="cpu")


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = (flash_attention.LAUNCHES, decode_attention.LAUNCHES)
    yield
    assert (flash_attention.LAUNCHES, decode_attention.LAUNCHES) == before


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_matches_the_reference_engine_exactly(name, chunk):
    """f32: the same greedy tokens and the same per-request QoE records,
    through continuous batching over ragged, bucketed prompts."""
    rcfg, params, cfg, model = _pair(name, "float32")
    ec = dict(max_slots=3, max_seq=64, max_new_tokens=5, prefill_bucket=16)
    ref_eng = RefEngine(rcfg, params, RefEngineConfig(**ec))
    eng = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    rng = np.random.default_rng(0)
    for i in range(7):
        p = rng.integers(0, cfg.vocab, size=3 + 6 * i)
        budget = int(rng.integers(1, 8))
        ref_eng.submit(i, p, max_new_tokens=budget)
        eng.submit(i, p, max_new_tokens=budget)
    want = ref_eng.run_to_completion(chunk=chunk)
    got = eng.run_to_completion(chunk=chunk)
    assert sorted(got) == sorted(want) == list(range(7))
    for i in want:
        assert got[i] == want[i], i
    assert eng.qoe_summary() == ref_eng.qoe_summary()
    assert eng._steps == ref_eng._steps
    assert eng.tokens_emitted == ref_eng.tokens_emitted


def test_idle_slot_overrun_runs_as_the_reference_does():
    """A slot that is never admitted grows its kv_len past max_seq by one
    per step (the reference's decode adds 1 to every row): the port must
    clamp the write as the reference does and serve the same tokens."""
    rcfg, params, cfg, model = _pair("qwen3-1.7b", "float32")
    ec = dict(max_slots=2, max_seq=32, max_new_tokens=20, prefill_bucket=16)
    ref_eng = RefEngine(rcfg, params, RefEngineConfig(**ec))
    eng = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    rng = np.random.default_rng(5)
    idle = []
    for i in range(3):
        p = rng.integers(0, cfg.vocab, size=7)
        ref_eng.submit(i, p)
        eng.submit(i, p)
        want = ref_eng.run_to_completion()[i]
        assert eng.run_to_completion()[i] == want
        idle.append((int(eng.cache.kv_len[1]),
                     int(np.asarray(ref_eng.cache.kv_len)[1])))
    assert idle == [(19, 19), (38, 38), (57, 57)]
    assert idle[-1][0] > ec["max_seq"]


@pytest.mark.parametrize("name", NAMES)
def test_step_n_is_bit_identical_to_step(name):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=4 + 9 * i) for i in range(3)]
    runs = []
    for chunk in (1, 5):
        eng = _engine(name, max_slots=3, max_seq=64, max_new_tokens=9)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new_tokens=5 + 2 * i)
        runs.append((eng.run_to_completion(chunk=chunk), eng.host_syncs))
    (a, syncs_a), (b, syncs_b) = runs
    assert a == b
    assert syncs_b < syncs_a


def test_engine_ragged_lengths_independent():
    """A long-prompt slot must not perturb a short-prompt slot's output."""
    rng = np.random.default_rng(2)
    short = rng.integers(0, 512, size=5)
    long = rng.integers(0, 512, size=37)
    solo = _engine("stablelm-3b", max_slots=1, max_seq=64, max_new_tokens=5)
    solo.submit(0, short)
    want = solo.run_to_completion()[0]["tokens"]
    both = _engine("stablelm-3b", max_slots=2, max_seq=64, max_new_tokens=5)
    both.submit(0, short)
    both.submit(1, long)
    assert both.run_to_completion()[0]["tokens"] == want


def test_engine_continuous_batching_admits_from_queue():
    eng = _engine("qwen3-1.7b", max_slots=2, max_seq=64, max_new_tokens=4)
    rng = np.random.default_rng(3)
    for i in range(6):
        eng.submit(i, rng.integers(0, 512, size=6))
    assert eng.active_count == 2 and eng.queue_len == 6
    results = eng.run_to_completion(chunk=3)
    assert sorted(results) == list(range(6))
    assert all(len(r["tokens"]) == 4 for r in results.values())
    assert eng.admissions == 6


def _served_and_forced(name, dtype):
    """Serve two prompts; return [(prompt, tokens, teacher-forced logits of
    each emitted token's row)] with the same weights."""
    _, _, cfg, model = _pair(name, dtype)
    eng = _engine(name, dtype, max_slots=2, max_seq=64, max_new_tokens=6)
    rng = np.random.default_rng(4)
    prompts = {i: rng.integers(0, cfg.vocab, size=8 + i) for i in range(2)}
    for i, p in prompts.items():
        eng.submit(i, p)
    results = eng.run_to_completion(chunk=4)
    out = []
    for i, p in prompts.items():
        toks = results[i]["tokens"]
        seq = torch.tensor([list(p) + toks[:-1]])
        logits = lm.train_logits(model, cfg, seq)[0, len(p) - 1:]
        out.append((p, toks, logits))
    return cfg, model, out


@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_teacher_forced_greedy(name):
    """f32: the engine's tokens are exactly the offline greedy tokens of
    repeated full forward passes (``train_logits``), as the reference's
    ``tests/test_serving.py`` holds its engine."""
    cfg, model, runs = _served_and_forced(name, "float32")
    for p, toks, _ in runs:
        seq = list(p)
        for _ in range(len(toks)):
            logits = lm.train_logits(model, cfg, torch.tensor([seq]))
            seq.append(int(torch.argmax(logits[0, -1])))
        assert toks == seq[len(p):]


@pytest.mark.parametrize("name", NAMES)
def test_engine_tokens_are_teacher_forced_maxima_in_bf16(name):
    """bf16: decode (``ref.gqa_decode`` rounds the softmax weights to bf16,
    as the reference's oracle does) and full-sequence attention
    (``ref.mha_prefill`` keeps them in f32) round differently, so a near-tie
    may flip. Each emitted token's teacher-forced logit must lie within
    2e-2 * max|logit| of its row's max, the criterion ``chip_smoke.py``
    applies on the card."""
    _, _, runs = _served_and_forced(name, "bfloat16")
    for _, toks, logits in runs:
        picked = logits[torch.arange(len(toks)), torch.tensor(toks)]
        gap = logits.max(dim=-1).values - picked
        assert bool((gap <= 2e-2 * logits.abs().max(dim=-1).values).all())


def test_cancel_frees_the_slot_and_the_queue():
    eng = _engine("qwen3-1.7b", max_slots=1, max_seq=64, max_new_tokens=4)
    rng = np.random.default_rng(6)
    for i in range(3):
        eng.submit(i, rng.integers(0, 512, size=6))
    assert eng.cancel(2) and eng.cancel(0)
    assert not eng.cancel(7)
    assert eng.slots[0].request_id == 1
    assert sorted(eng.run_to_completion()) == [1]


def test_later_slices_raise():
    _, _, cfg, model = _pair("qwen3-1.7b", "bfloat16")
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        LLMEngine(cfg, model, EngineConfig(prefix_cache=True), device="cpu")
    eng = _engine("qwen3-1.7b")
    for call in (lambda: eng.prefill_only(0, [1, 2]),
                 lambda: eng.export_kv([0]), lambda: eng.import_kv([1], None),
                 eng.flush_kv, lambda: eng._attach_fleet(None, 0)):
        with pytest.raises(NotImplementedError):
            call()


def test_serve_tokenizes_as_the_cluster_server_does():
    """``serve.tokenize`` is the cluster server's word-level tokenizer, its
    cap a parameter (the whole prompt by default)."""
    reqs = ref_build_trace(500, seed=0).requests[:40]
    mine = serve.build_trace(500, seed=0).requests[:40]
    for vocab in (512, 151936):
        for r, m in zip(reqs, mine):
            for cap in (24, 10 ** 6):
                np.testing.assert_array_equal(
                    serve.tokenize(m, vocab, cap),
                    ClusterServer._tokenize(None, r, vocab, cap=cap))
            assert len(serve.tokenize(m, vocab)) == len(m.text.split())
    assert [serve.budget(x) for x in (0.2, 3.1, 34.6, 99.0)] == [1, 3, 35, 64]


def test_serve_smoke_run_on_the_cpu():
    run = serve.run_serve("qwen3-1.7b", n_requests=10, device="cpu",
                          smoke=True)
    assert sorted(run.results) == list(range(10))
    for rid, r in run.results.items():
        assert len(r["tokens"]) == run.budgets[rid]
        assert r["prompt_tokens"] == len(run.prompts[rid])
    assert run.engine.admissions == 10
    assert "QoE" in serve.format_run(run)[-1]
