"""The serving engine on the non-dense model families, against the
reference engine: the MoE
models (dbrx, llama4), the Jamba hybrid (Mamba + MoE + attention), xLSTM,
llama-3.2-vision (cross-attention over patch embeddings) and whisper (an
encoder over frames, self- and cross-attention in the decoder), each at
the reference's ``smoke()`` size in f32, with the reference's ``lm.init``
weights carried over by ``convert.lm_params_from_numpy``; tokens, frames
and patches are made with numpy from a seed (frames and patches rounded to
bf16, as the reference engine rounds them).

The engine's greedy tokens, QoE records and prefix-cache counters must
equal the reference engine's exactly in f32, as must a fleet cohort's
against engines stepping alone (the forward passes are held in
``tests/test_torch_families.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefEngine
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import lm
from repro_torch.serving import EngineConfig, LLMEngine
from repro_torch.serving import fleet as fleet_mod

FAMILIES = ("dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "xlstm-1.3b", "llama-3.2-vision-11b", "whisper-tiny")
ECFG = dict(max_slots=3, max_seq=64, max_new_tokens=5, prefill_bucket=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = (flash_attention.LAUNCHES, decode_attention.LAUNCHES)
    yield
    assert (flash_attention.LAUNCHES, decode_attention.LAUNCHES) == before


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(reference cfg, reference params, port cfg, port model), f32."""
    rcfg = dataclasses.replace(ref_get(name).smoke(), dtype="float32")
    cfg = dataclasses.replace(get(name).smoke(), dtype="float32")
    params = rlm.init(jax.random.key(0), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return rcfg, params, cfg, model


def _cross(cfg, B, seed):
    """(reference batch keys, port keywords, engine extra) of random bf16
    frames or patches, (B, T, d); empty for the other families."""
    if cfg.family not in ("audio", "vlm"):
        return {}, {}, [{}] * B
    key = "frames" if cfg.family == "audio" else "patches"
    x = np.random.default_rng(seed).standard_normal(
        (B, cfg.cross_kv_tokens, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return ({key: xj}, {key: tensor_from_numpy(np.asarray(xj), "cpu")},
            [{key: x[b:b + 1]} for b in range(B)])


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_matches_the_reference_engine(name):
    """Greedy tokens and QoE records equal the reference engine's: ragged
    prompts, continuous batching over 3 slots, decode chunks of 4 (one
    step while work is queued); frames and patches through
    ``submit(extra=)``."""
    rcfg, params, cfg, model = _pair(name)
    ref_eng = RefEngine(rcfg, params, RefEngineConfig(**ECFG))
    eng = LLMEngine(cfg, model, EngineConfig(**ECFG), device="cpu")
    assert eng._bucket_ok == ref_eng._bucket_ok == False  # noqa: E712
    assert eng.fleet_ok == ref_eng.fleet_ok
    rng = np.random.default_rng(3)
    _, _, extras = _cross(cfg, 5, 4)
    for i in range(5):
        p = rng.integers(0, cfg.vocab, size=(4, 11, 18)[i % 3])
        budget = int(rng.integers(1, 7))
        ref_eng.submit(i, p, max_new_tokens=budget, extra=extras[i])
        eng.submit(i, p, max_new_tokens=budget, extra=extras[i])
    want = ref_eng.run_to_completion(chunk=4)
    got = eng.run_to_completion(chunk=4)
    assert sorted(got) == sorted(want) == list(range(5))
    for i in want:
        assert got[i] == want[i], i
    assert eng._steps == ref_eng._steps
    assert eng.tokens_emitted == ref_eng.tokens_emitted


def test_engine_frames_default_to_zeros_and_are_checked():
    _, _, cfg, model = _pair("whisper-tiny")
    prompt = np.arange(6) % cfg.vocab
    runs = []
    for extra in (None, {"frames": np.zeros((1, 64, cfg.d_model))}):
        eng = LLMEngine(cfg, model, EngineConfig(**ECFG), device="cpu")
        eng.submit(0, prompt, max_new_tokens=3, extra=extra)
        runs.append(eng.run_to_completion()[0]["tokens"])
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="frames must be"):
        eng.submit(1, prompt, extra={"frames": np.zeros((1, 8, 64))})
    with pytest.raises(ValueError, match="needs patches"):
        _, _, vcfg, vmodel = _pair("llama-3.2-vision-11b")
        lm.prefill(vmodel, vcfg, torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_gates_follow_the_reference(name):
    """Prompts are padded to a bucket only for pure-attention, non-MoE
    patterns; the paged prefix cache takes pure-attention patterns only
    (MoE FFNs included); MoE engines never join a fleet cohort."""
    rcfg, params, cfg, model = _pair(name)
    pure = all(m == "attn" for m, _ in cfg.pattern) and cfg.family not in (
        "audio", "vlm")
    paged = dict(ECFG, prefix_cache=True, block_size=4, cache_blocks=16)
    if pure:
        assert LLMEngine(cfg, model, EngineConfig(**paged),
                         device="cpu").kv is not None
    else:
        with pytest.raises(ValueError, match="pure-attention"):
            LLMEngine(cfg, model, EngineConfig(**paged), device="cpu")
        with pytest.raises(AssertionError):
            RefEngine(rcfg, params, RefEngineConfig(**paged))
    moe = any(f == "moe" for _, f in cfg.pattern)
    eng = LLMEngine(cfg, model, EngineConfig(**ECFG), device="cpu")
    assert eng.fleet_ok == (not moe)
    assert not eng._bucket_ok and not lm.bucketable(cfg)
    with pytest.raises(ValueError, match="cannot pad"):
        lm.prefill(model, cfg, torch.zeros((1, 8), dtype=torch.int64),
                   length=5, **_cross(cfg, 1, 0)[1])
    if not pure:
        with pytest.raises(ValueError, match="pure-attention"):
            lm.prefill_extend(model, cfg,
                              torch.zeros((1, 2), dtype=torch.int64),
                              (torch.zeros(1), torch.zeros(1)))


def test_moe_prefix_cache_engine_matches_the_reference():
    """dbrx is pure attention with MoE FFNs: the reference pages its K/V,
    and so does the port. Prompts sharing whole blocks reuse them
    (``prefill_extend`` with MoE capacity over the suffix alone); tokens,
    QoE records and cache counters equal the reference's."""
    rcfg, params, cfg, model = _pair("dbrx-132b")
    ec = dict(ECFG, prefix_cache=True, block_size=4, cache_blocks=24)
    ref_eng = RefEngine(rcfg, params, RefEngineConfig(**ec))
    eng = LLMEngine(cfg, model, EngineConfig(**ec), device="cpu")
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab, size=13)
    for i in range(4):
        p = np.concatenate([base, rng.integers(0, cfg.vocab, size=2 + 3 * i)])
        ref_eng.submit(i, p, max_new_tokens=3)
        eng.submit(i, p, max_new_tokens=3)
    want = ref_eng.run_to_completion(chunk=2)
    got = eng.run_to_completion(chunk=2)
    assert got == want
    assert eng.cache_stats() == ref_eng.cache_stats()
    assert eng.cache_stats()["hits"] > 0


@pytest.mark.parametrize("name", ["xlstm-1.3b", "whisper-tiny"])
def test_fleet_cohort_equals_engines_stepping_alone(name):
    """Three engines of one model decode as one cohort (every cache leaf,
    recurrent state and cross K/V included, flattened into the batch) and
    give the tokens of three engines stepping alone. Work arrives while
    others decode, so members sit out dispatches with queued work and
    step alone, their recurrent state kept across the cohort's chunks."""
    _, _, cfg, model = _pair(name)
    ecfg = EngineConfig(max_slots=2, max_seq=48, max_new_tokens=5)
    _, _, extras = _cross(cfg, 9, 6)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=3 + 2 * i) for i in range(9)]
    budgets = [int(rng.integers(2, 8)) for _ in range(9)]

    def run(fleet):
        engines = [LLMEngine(cfg, model, ecfg, device="cpu")
                   for _ in range(3)]
        cohort = fleet_mod.Cohort(engines) if fleet else None
        if fleet:
            c = cohort.state.cache
            assert sorted(c.state) == sorted(engines[0].cache.state)
            for leaf, own in zip(c.state.values(),
                                 engines[1].cache.state.values()):
                assert own.data_ptr() == leaf[:, 2].data_ptr()
        for tick in range(40):
            for r in range(9):
                if r // 3 == tick % 4 and tick < 4:
                    engines[r % 3].submit(r, prompts[r], budgets[r],
                                          extra=extras[r])
            if fleet:
                res = cohort.dispatch(3, range(3))
                for m, work in res.work.items():
                    engines[m]._commit_chunk(work)
                for m, e in enumerate(engines):
                    if m not in res.work and e.queue:
                        e.step()
            else:
                for e in engines:
                    e.step_n(3)
        return [e.results for e in engines]

    solo, fleet = run(False), run(True)
    assert sum(len(r) for r in solo) == 9
    assert fleet == solo
