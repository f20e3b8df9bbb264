"""The port's MoE held against the reference's ``repro.models.moe``, the
twins of ``tests/test_moe.py``: no drops against a dense reference,
capacity rounding, drops at a tiny capacity keeping exactly the reference's
(token, expert) slots, the tie order of a uniform router, slot accounting
and the aux loss.

f32 throughout (``dtype="float32"``): the port and the reference compute
the same router probabilities, choices and dispatch, so which assignments
drop is exact; outputs agree within 1e-6 (one f32 product order of the
expert GEMMs against another) and the aux loss within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.config import MoECfg as RefMoECfg
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig, MoECfg

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(n_experts=4, top_k=2, cap=8.0, d=32, ff=48):
    """(reference cfg, port cfg) of ``tests/test_moe.py``'s ``_cfg``, f32."""
    kw = dict(name="moe-test", family="moe", n_layers=2, d_model=d,
              n_heads=2, n_kv_heads=2, d_ff=ff, vocab=64,
              pattern=(("attn", "moe"),), dtype="float32")
    return (RefModelConfig(moe=RefMoECfg(n_experts, top_k, ff, cap), **kw),
            ModelConfig(moe=MoECfg(n_experts, top_k, ff, cap), **kw))


def _pair(rcfg, cfg, seed=0, router=None):
    """Reference params and the port's ``lm.MoE`` with the same values."""
    p = RM.moe_init(jax.random.key(seed), rcfg)
    if router is not None:
        p = dict(p, router={"w": router(p["router"]["w"])})
    mod = lm.MoE(cfg, "cpu")
    for attr, (name, leaf) in mod.REF.items():
        getattr(mod, attr).copy_(
            tensor_from_numpy(np.asarray(p[name][leaf]), "cpu"))
    return p, mod


def _x(shape, seed=1):
    x = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                     jnp.float32))
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _dense_reference(p, cfg, x):
    """All experts on all tokens, combined by renormalized top-k weights
    (``tests/test_moe.py``'s oracle)."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, p["router"]["w"]), -1)
    top_w, top_e = jax.lax.top_k(probs, m.top_k)
    top_w = top_w / jnp.sum(top_w, -1, keepdims=True)
    h = jnp.einsum("td,edf->etf", xt, p["wi"]["w"])
    g = jnp.einsum("td,edf->etf", xt, p["wg"]["w"])
    y_all = jnp.einsum("etf,efd->etd", jax.nn.silu(g) * h, p["wo"]["w"])
    w_e = jnp.einsum("tke,tk->te", jax.nn.one_hot(top_e, m.n_experts), top_w)
    return jnp.einsum("etd,te->td", y_all, w_e).reshape(B, S, d)


def _apply(mod, cfg, xt):
    """(y, aux, dropped assignments), the drops read from ``ROUTING``."""
    M.ROUTING = []
    try:
        y, aux = M.moe_apply(mod, cfg, xt)
        (top_e, drops), = M.ROUTING
        assert top_e.shape == (xt.shape[0] * xt.shape[1], cfg.moe.top_k)
    finally:
        M.ROUTING = None
    return y, aux, int(drops)


def _numpy_drops(top_e, E, C):
    """Dropped assignments of a stable sort by expert (numpy's own)."""
    flat = np.asarray(top_e).reshape(-1)
    srt = flat[np.argsort(flat, kind="stable")]
    starts = np.concatenate([[0], np.cumsum(np.bincount(srt, minlength=E))
                             [:-1]])
    return int((np.arange(len(flat)) - starts[srt] >= C).sum())


@pytest.mark.parametrize("n_experts,top_k", [(4, 1), (4, 2), (8, 4)])
def test_moe_matches_reference_and_dense_without_drops(n_experts, top_k):
    rcfg, cfg = _cfgs(n_experts, top_k, cap=float(n_experts))
    p, mod = _pair(rcfg, cfg)
    xj, xt = _x((2, 16, cfg.d_model))
    want, want_aux = RM.moe_apply(p, rcfg, xj)
    got, aux, drops = _apply(mod, cfg, xt)
    assert drops == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)
    # the dense oracle sums the experts in another order
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_dense_reference(p, rcfg, xj)),
                               atol=1e-5, rtol=1e-5)


def test_moe_capacity_rounds_like_the_reference():
    for cap in (0.01, 1.25, 8.0):
        for n_experts, top_k in ((4, 2), (16, 4), (128, 1)):
            rcfg, cfg = _cfgs(n_experts, top_k, cap=cap)
            for T in (1, 7, 8, 9, 64, 100, 1504):
                c = M.capacity(cfg, T)
                assert c == RM.capacity(rcfg, T)
                assert c % 8 == 0 and c >= 8


def test_moe_drops_at_tiny_capacity_keep_the_reference_slots():
    """capacity_factor 0.01 gives C = 8 slots an expert for 128
    assignments: most drop. The kept (token, expert) slots are the
    reference's: the outputs agree to f32 rounding (a different slot set
    would move them by O(1)), the tokens whose every choice dropped are
    zero in both, and the drop count is numpy's for a stable sort."""
    rcfg, cfg = _cfgs(cap=0.01)
    p, mod = _pair(rcfg, cfg)
    xj, xt = _x((2, 32, cfg.d_model))
    want, _ = RM.moe_apply(p, rcfg, xj)
    got, _, drops = _apply(mod, cfg, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    zero_got = (got.reshape(-1, cfg.d_model) == 0).all(-1).numpy()
    zero_want = (np.asarray(want).reshape(-1, cfg.d_model) == 0).all(-1)
    assert zero_got.any() and (zero_got == zero_want).all()
    probs = jax.nn.softmax(xj.reshape(-1, cfg.d_model) @ p["router"]["w"])
    _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    assert drops == _numpy_drops(top_e, 4, M.capacity(cfg, 64)) > 0
    assert np.isfinite(got.numpy()).all()
    assert (np.linalg.norm(got.numpy())
            < np.linalg.norm(np.asarray(_dense_reference(p, rcfg, xj))))


def test_moe_uniform_router_ties_and_aux_loss():
    """A zero router makes every probability equal: ``jax.lax.top_k`` takes
    the lowest expert id, so every token picks expert 0 (top-1) and the
    stable dispatch keeps the first C tokens. The port must tie the same
    way. The aux loss E · Σ f·p is 1 for a uniform router (here f = (1, 0,
    0, 0), p = 1/4 each)."""
    rcfg, cfg = _cfgs(n_experts=4, top_k=1, cap=1.25)
    p, mod = _pair(rcfg, cfg, router=jnp.zeros_like)
    xj, xt = _x((4, 64, cfg.d_model), seed=2)
    want, want_aux = RM.moe_apply(p, rcfg, xj)
    got, aux, drops = _apply(mod, cfg, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert abs(float(aux) - float(want_aux)) < TOL and 0.9 < float(aux) < 1.1
    kept = (got.reshape(-1, cfg.d_model) != 0).any(-1).numpy()
    assert drops == 256 - M.capacity(cfg, 256) == 256 - int(kept.sum())
    assert kept[:M.capacity(cfg, 256)].all()
    # top-k of equal values: the lower ids, in order
    w, idx = M.top_k(torch.full((3, 6), 0.25), 3)
    assert idx.tolist() == [[0, 1, 2]] * 3 and (w == 0.25).all()


@pytest.mark.parametrize("seed", range(6))
def test_moe_slot_accounting(seed):
    """Random choices with many equal ids: the port's dispatch drops what a
    stable numpy sort drops, and the reference's output is matched."""
    rcfg, cfg = _cfgs(n_experts=4, top_k=2, cap=0.5)
    p, mod = _pair(rcfg, cfg, seed=seed)
    xj, xt = _x((1, 64, cfg.d_model), seed=seed + 10)
    want, _ = RM.moe_apply(p, rcfg, xj)
    got, _, drops = _apply(mod, cfg, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    probs = jax.nn.softmax(xj.reshape(-1, cfg.d_model) @ p["router"]["w"])
    _, top_e = jax.lax.top_k(probs, 2)
    assert drops == _numpy_drops(top_e, 4, M.capacity(cfg, 64))


def test_moe_in_bf16_matches_the_reference_at_bf16_tolerance():
    """The served dtype: bf16 experts, f32 router. Within 2e-2, as the
    reference's own test holds its dispatch against the dense oracle."""
    rcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    p, mod = _pair(rcfg, cfg)
    x = np.asarray(jax.random.normal(jax.random.key(3), (2, 16, 32)))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    want, _ = RM.moe_apply(p, rcfg, xj)
    got, _, _ = _apply(mod, cfg, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
