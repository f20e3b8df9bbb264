"""The non-dense model families in the port against the reference: the MoE
models (dbrx, llama4), the Jamba hybrid (Mamba + MoE + attention), xLSTM,
llama-3.2-vision (cross-attention over patch embeddings) and whisper (an
encoder over frames, self- and cross-attention in the decoder), each at
the reference's ``smoke()`` size in f32, with the reference's ``lm.init``
weights carried over by ``convert.lm_params_from_numpy``; tokens, frames
and patches are made with numpy from a seed (frames and patches rounded to
bf16, as the reference engine rounds them).

Tolerances (f32): ``prefill`` + two ``decode_step``s, ``train_logits`` and
the caches within 1e-5 × max(1, max|reference|) — one f32 reduction order
against another, for every family whose recurrences are short; xLSTM
within 5e-5 × the same: seven mLSTM layers' exponential gates carry the
differences of the reference's jitted scan bodies (XLA fuses them and
contracts multiply-adds) through eight layers (2.3e-5 measured on max|logit|
0.61). The serving engine on these families is held in
``tests/test_torch_families_engine.py``.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import lm as rlm
from repro_torch.configs import ARCHS, get
from repro_torch.convert import (cache_from_numpy, lm_params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import lm

FAMILIES = ("dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "xlstm-1.3b", "llama-3.2-vision-11b", "whisper-tiny")
REPO = Path(__file__).resolve().parent.parent


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


def _tol(name):
    return 5e-5 if name == "xlstm-1.3b" else 1e-5


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               atol=atol, rtol=tol)


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
def test_prefill_decode_and_train_logits_match(name):
    rcfg, params, cfg, model = _pair(name)
    tol = _tol(name)
    B, S = 2, 19
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    rbatch, kw, _ = _cross(cfg, B, 2)
    batch = dict(rbatch, tokens=jnp.asarray(toks))
    want, _ = rlm.train_logits(params, rcfg, batch)
    _close(lm.train_logits(model, cfg, torch.from_numpy(toks), **kw)[0],
           want, tol)
    lw, cw = rlm.prefill(params, rcfg, batch, max_seq=S + 3)
    lg, cg = lm.prefill(model, cfg, torch.from_numpy(toks), max_seq=S + 3,
                        **kw)
    _close(lg, lw, tol)
    tok = np.asarray(jnp.argmax(lw, -1))[:, None]
    for _ in range(2):
        lw, cw = rlm.decode_step(params, rcfg, jnp.asarray(tok, jnp.int32),
                                 cw)
        lg, cg = lm.decode_step(model, cfg, torch.from_numpy(tok), cg)
        _close(lg, lw, tol)
        tok = np.asarray(jnp.argmax(lw, -1))[:, None]
    want = cache_from_numpy(jax.tree.map(np.asarray, cw), "cpu", cfg)
    assert sorted(cg.state) == sorted(want.state)
    assert torch.equal(cg.kv_len, want.kv_len)
    assert cg.k.shape[0] == want.k.shape[0] == lm.n_attn(cfg)
    for got, ref in [(cg.k, want.k), (cg.v, want.v)][:lm.n_attn(cfg) and 2] + [
            (cg.state[k], want.state[k]) for k in want.state]:
        assert got.dtype == ref.dtype
        _close(got, ref.numpy(), tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_built_parameters_are_the_reference_s(arch):
    """Every architecture at its smoke size has the reference's leaves,
    element for element; at its published widths (built on the meta
    device) it has ``param_counts()["total"]`` plus what that arithmetic
    leaves out, as ``chip_smoke.py`` asserts of the models it builds."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mod = get(arch)
    rcfg = ref_get(mod.NAME).smoke()
    shapes = jax.eval_shape(lambda: rlm.init(jax.random.key(0), rcfg))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    cfg = mod.smoke()
    assert sum(p.numel() for p in lm.LM(cfg, "meta").parameters()) == want
    for c in (cfg, mod.config(), dataclasses.replace(
            mod.config(), n_layers=len(mod.config().pattern))):
        built = sum(p.numel() for p in lm.LM(c, "meta").parameters())
        assert built == c.param_counts()["total"] + smoke.uncounted_params(c)
