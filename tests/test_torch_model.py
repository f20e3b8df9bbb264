"""The port's dense LM held against the reference, layer by layer and whole.

The reference's ``lm.init`` pytree reaches the port through
``convert.lm_params_from_numpy``; inputs are made with numpy from a seed and
go through both packages. Tolerance 1e-5 for the f32 configs
(``dataclasses.replace(cfg, dtype="float32")``) and 2e-2 in bf16, where the
two frameworks round at different places (the reference's CPU prefill scales
q and rounds the softmax weights in bf16, the port's plain flash path does
not); bf16 K/V caches are held at 2e-2 of their largest magnitude. Both
the GQA smoke config (qwen3-1.7b: qk-norm, group 2, rope 1e6) and the MHA
one (stablelm-3b) are covered.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import layers as RL
from repro.models import lm as rlm
from repro_torch.configs import get
from repro_torch.convert import (cache_from_numpy, lm_params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import layers as L
from repro_torch.models import lm

NAMES = ("qwen3-1.7b", "stablelm-3b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(n, d) for n in NAMES for d in TOL]


@functools.lru_cache(maxsize=None)
def _pair(name: str, dtype: str):
    """(reference cfg, reference params, port cfg, port model)."""
    rcfg = dataclasses.replace(ref_get(name).smoke(), dtype=dtype)
    cfg = dataclasses.replace(get(name).smoke(), dtype=dtype)
    params = rlm.init(jax.random.key(0), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return rcfg, params, cfg, model


def _close(got: torch.Tensor, want, tol: float, scaled: bool = False):
    """allclose at ``tol``; ``scaled`` takes the absolute part relative to
    the largest |want|, for bf16 K/V caches, whose deeper layers carry the
    residual stream's rounding (a few bf16 ulps at |x| ~ 4)."""
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               atol=atol, rtol=tol)


def _act(rng, shape, dtype):
    """A random activation as (jnp, torch) with the same bits."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu")


def _block0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"][0])


def test_configs_match_the_reference():
    for name in NAMES:
        for fn in ("config", "smoke"):
            a = getattr(get(name), fn)()
            b = getattr(ref_get(name), fn)()
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.param_counts() == b.param_counts()
            assert a.hd == b.hd and a.q_dim == b.q_dim
    assert get("qwen3_1p7b") is get("qwen3-1.7b")
    with pytest.raises(KeyError):
        get("dbrx-132b")


def test_init_shapes_dtypes_and_scales_match_lm_init():
    rcfg, params, cfg, _ = _pair("qwen3-1.7b", "bfloat16")
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_np = jax.tree.map(np.asarray, params)
    # the converted reference is a model of the same structure
    conv = lm_params_from_numpy(ref_np, cfg, "cpu")
    for (n1, p1), (n2, p2) in zip(model.named_parameters(),
                                  conv.named_parameters()):
        assert n1 == n2 and p1.shape == p2.shape and p1.dtype == p2.dtype
    assert model.blocks[0].mixer.qnorm.dtype == torch.float32
    assert bool((model.final_norm.g == 1).all())
    for got, want in ((model.embed, 0.02),
                      (model.blocks[1].ffn.wo, cfg.d_ff ** -0.5),
                      (model.blocks[2].mixer.wq, cfg.d_model ** -0.5)):
        assert abs(float(got.float().std()) / want - 1) < 0.05


def test_non_dense_patterns_raise():
    cfg = dataclasses.replace(get("qwen3-1.7b").smoke(),
                              pattern=(("mamba", "none"),))
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        lm.LM(cfg, "cpu")


@pytest.mark.parametrize("name,dtype", CASES)
def test_norms_rope_ffn_unembed_match(name, dtype):
    rcfg, params, cfg, model = _pair(name, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    p, blk = _block0(params), model.blocks[0]
    xj, xt = _act(rng, (2, 9, cfg.d_model), dtype)
    g = rng.standard_normal(cfg.d_model).astype(np.float32)
    b = rng.standard_normal(cfg.d_model).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(g), xt, cfg.norm_eps),
           RL.rms_norm({"g": jnp.asarray(g)}, xj, rcfg.norm_eps), tol)
    _close(L.layer_norm(torch.from_numpy(g), torch.from_numpy(b), xt),
           RL.layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, xj),
           tol)
    hj, ht = _act(rng, (2, 9, cfg.n_heads, cfg.hd), dtype)
    pos = rng.integers(0, 4000, (2, 9))
    _close(L.rope(ht, torch.from_numpy(pos), cfg.rope_theta),
           RL.rope(hj, jnp.asarray(pos), rcfg.rope_theta), tol)
    _close(L.ffn_apply(blk.ffn, xt),
           RL.ffn_apply(p["ffn"], xj, rcfg.activation), tol)
    _close(L.unembed(model.head, xt),
           RL.unembed(params["head"], xj), tol)


@pytest.mark.parametrize("name,dtype", CASES)
def test_attention_layers_match(name, dtype):
    rcfg, params, cfg, model = _pair(name, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(2)
    p, blk = _block0(params), model.blocks[0]
    S = 21
    xj, xt = _act(rng, (2, S, cfg.d_model), dtype)
    pos_j, pos_t = jnp.arange(S)[None], torch.arange(S)[None]
    for got, want in zip(L._qkv(blk.mixer, cfg, xt, xt),
                         RL._qkv(p["mixer"], rcfg, xj, xj)):
        _close(got, want, tol)
    _close(L.attention(blk.mixer, cfg, xt, positions=pos_t),
           RL.attention(p["mixer"], rcfg, xj, positions=pos_j), tol)
    y, (k, v) = L.attention_prefill_cache(blk.mixer, cfg, xt, pos_t)
    ry, (rk, rv) = RL.attention_prefill_cache(p["mixer"], rcfg, xj, pos_j)
    for got, want in ((y, ry), (k, rk), (v, rv)):
        _close(got, want, tol)


@pytest.mark.parametrize("name,dtype", CASES)
def test_attention_decode_matches_and_clamps_the_write(name, dtype):
    """One decode layer against the reference, with one row at a length
    past Smax: both write at Smax - 1 and attend the whole cache."""
    rcfg, params, cfg, model = _pair(name, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    p, blk = _block0(params), model.blocks[0]
    Smax = 32
    xj, xt = _act(rng, (3, 1, cfg.d_model), dtype)
    kj, kt = _act(rng, (3, Smax, cfg.n_kv_heads, cfg.hd), dtype)
    vj, vt = _act(rng, (3, Smax, cfg.n_kv_heads, cfg.hd), dtype)
    pos = np.array([0, 17, Smax + 6], np.int32)
    y = L.attention_decode(blk.mixer, cfg, xt, (kt, vt),
                           torch.from_numpy(pos))
    ry, (rk, rv) = RL.attention_decode(p["mixer"], rcfg, xj, (kj, vj),
                                       jnp.asarray(pos))
    _close(y, ry, tol)
    _close(kt, rk, tol)      # written in place
    _close(vt, rv, tol)


@pytest.mark.parametrize("name,dtype", CASES)
def test_prefill_decode_and_train_logits_match(name, dtype):
    rcfg, params, cfg, model = _pair(name, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(4)
    before = (flash_attention.LAUNCHES, decode_attention.LAUNCHES)
    length, S_pad, max_seq = 19, 32, 48
    toks = np.zeros((1, S_pad), np.int32)
    toks[0, :length] = rng.integers(0, cfg.vocab, length)
    logits, cache = lm.prefill(model, cfg, torch.from_numpy(toks),
                               max_seq=max_seq, length=length)
    rlogits, rcache = rlm.prefill(params, rcfg, {"tokens": jnp.asarray(toks)},
                                  max_seq=max_seq, length=jnp.int32(length))
    _close(logits, rlogits, tol)
    (rk, rv), = rcache.layer
    assert cache.k.shape == rk.shape == (cfg.n_layers, 1, max_seq,
                                         cfg.n_kv_heads, cfg.hd)
    _close(cache.k, rk, tol, scaled=True)
    _close(cache.v, rv, tol, scaled=True)
    assert cache.kv_len.tolist() == [length]

    # one decode step from the reference's own cache, carried across
    port_cache = cache_from_numpy(jax.tree.map(np.asarray, rcache), "cpu")
    tok = np.array([[int(np.argmax(np.asarray(rlogits)[0]))]], np.int32)
    dlogits, dcache = lm.decode_step(model, cfg, torch.from_numpy(tok),
                                     port_cache)
    rdl, rdc = rlm.decode_step(params, rcfg, jnp.asarray(tok), rcache)
    _close(dlogits, rdl, tol)
    _close(dcache.k, rdc.layer[0][0], tol, scaled=True)
    _close(dcache.v, rdc.layer[0][1], tol, scaled=True)
    assert dcache.kv_len.tolist() == np.asarray(rdc.kv_len).tolist()

    seq = rng.integers(0, cfg.vocab, (2, 23)).astype(np.int32)
    rl, _ = rlm.train_logits(params, rcfg, {"tokens": jnp.asarray(seq)})
    _close(lm.train_logits(model, cfg, torch.from_numpy(seq)), rl, tol)
    assert (flash_attention.LAUNCHES, decode_attention.LAUNCHES) == before
