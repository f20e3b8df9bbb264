"""The port's non-attention mixers held against the reference's, layer by
layer: the Mamba selective scan (``repro.models.ssm``), the mLSTM and sLSTM
(``repro.models.xlstm``), cross-attention over cached K/V and the GELU MLP
(``repro.models.layers``). Inputs are made with numpy from a seed; weights
are the reference's ``*_init`` carried over leaf by leaf (each port
module's ``REF``).

Tolerances, f32 (``dtype="float32"`` smoke configs):

* the associative scan is bit-equal to ``jax.lax.associative_scan`` run
  eagerly: the port combines in its tree order;
* each mixer's output and state within 1e-5 × max(1, max|reference|): the
  reference runs its chunk loop and sLSTM steps inside jitted ``lax.scan``
  bodies, where XLA fuses and contracts multiply-adds, and its
  ``cumsum``/``einsum`` reduction orders are XLA's; measured differences
  are ~1e-6 of the magnitude (the mLSTM's matrix state reaches ~10);
* cross-attention and the GELU MLP within 1e-6 (the same ops, one
  reduction order against another); bf16 within 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get as ref_get
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import ssm as RS
from repro.models import xlstm as RX
from repro_torch.configs import get
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(ref_get(name).smoke(), dtype=dtype),
            dataclasses.replace(get(name).smoke(), dtype=dtype))


def _module(cls, cfg, tree):
    """The port module ``cls`` holding the reference leaves of ``tree``."""
    mod = cls(cfg, "cpu")
    for attr, path in mod.REF.items():
        dst = getattr(mod, attr)
        if dst is None:
            continue
        src = tree
        for key in path:
            src = src[key]
        dst.copy_(tensor_from_numpy(np.asarray(src), "cpu"))
    return mod


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               atol=atol, rtol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 16, 37])
def test_associative_scan_is_jax_order_bit_for_bit(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 5, 3)).astype(np.float32)

    def comb(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = S.associative_scan(S._combine, (torch.from_numpy(a),
                                          torch.from_numpy(b)), 1)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("L0", [1, 16, 40])
def test_mamba_forward_and_decode_match(L0):
    """L0 40 pads to 48 (chunk 16) with state-neutral steps; 16 is one
    whole chunk; 1 is a decode-sized forward."""
    rcfg, cfg = _cfgs("jamba-v0.1-52b")
    p = RS.mamba_init(jax.random.key(0), rcfg)
    mod = _module(lm.Mamba, cfg, p)
    x = _x((2, L0, cfg.d_model), L0)
    y_w, st_w = RS.mamba_forward(p, rcfg, jnp.asarray(x))
    y_g, st_g = S.mamba_forward(mod, cfg, torch.from_numpy(x))
    _close(y_g, y_w)
    for g, w in zip(st_g, st_w):
        _close(g, w)
    x1 = _x((2, 1, cfg.d_model), 99)
    y_w, st_w = RS.mamba_decode(p, rcfg, jnp.asarray(x1), st_w)
    y_g, st_g = S.mamba_decode(mod, cfg, torch.from_numpy(x1), st_g)
    _close(y_g, y_w)
    for g, w in zip(st_g, st_w):
        _close(g, w)


def test_mamba_padding_is_state_neutral():
    """The state after 40 tokens (padded to 48) equals the state after 20
    tokens continued by the next 20, and each token's decode step."""
    _, cfg = _cfgs("jamba-v0.1-52b")
    mod = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").blocks[1]
    mixer = mod.mixer
    assert isinstance(mixer, lm.Mamba)
    x = torch.from_numpy(_x((2, 40, cfg.d_model), 3))
    y, (h, cw) = S.mamba_forward(mixer, cfg, x)
    y1, st = S.mamba_forward(mixer, cfg, x[:, :20])
    y2, (h2, cw2) = S.mamba_forward(mixer, cfg, x[:, 20:], st)
    _close(torch.cat([y1, y2], 1), y.numpy())
    _close(h2, h.numpy())
    assert torch.equal(cw2, cw)
    st = None
    for t in range(40):
        yt, st = S.mamba_forward(mixer, cfg, x[:, t:t + 1], st)
        _close(yt[:, 0], y[:, t].numpy())
    _close(st[0], h.numpy())


@pytest.mark.parametrize("L0", [1, 16, 17, 40])
def test_mlstm_forward_and_decode_match(L0):
    """Padding (L0 17 and 40 at chunk 16) uses log f = 0, log i = -1e30:
    no NaN, and the carried state is the reference's."""
    rcfg, cfg = _cfgs("xlstm-1.3b")
    p = RX.mlstm_init(jax.random.key(0), rcfg)
    mod = _module(lm.MLSTM, cfg, p)
    x = _x((2, L0, cfg.d_model), L0)
    y_w, st_w = RX.mlstm_forward(p, rcfg, jnp.asarray(x))
    y_g, st_g = X.mlstm_forward(mod, cfg, torch.from_numpy(x))
    assert all(bool(torch.isfinite(t).all()) for t in (y_g, *st_g))
    _close(y_g, y_w)
    for g, w in zip(st_g, st_w):
        _close(g, w)
    x1 = _x((2, 1, cfg.d_model), 98)
    y_w, st_w = RX.mlstm_forward(p, rcfg, jnp.asarray(x1), state=st_w)
    y_g, st_g = X.mlstm_forward(mod, cfg, torch.from_numpy(x1), state=st_g)
    _close(y_g, y_w)
    for g, w in zip(st_g, st_w):
        _close(g, w)


@pytest.mark.parametrize("L0", [1, 9])
def test_slstm_forward_and_decode_match(L0):
    rcfg, cfg = _cfgs("xlstm-1.3b")
    p = RX.slstm_init(jax.random.key(1), rcfg)
    mod = _module(lm.SLSTM, cfg, p)
    x = _x((2, L0, cfg.d_model), L0 + 50)
    y_w, st_w = RX.slstm_forward(p, rcfg, jnp.asarray(x))
    y_g, st_g = X.slstm_forward(mod, cfg, torch.from_numpy(x))
    _close(y_g, y_w)
    for g, w in zip(st_g, st_w):
        _close(g, w)
    x1 = _x((2, 1, cfg.d_model), 97)
    y_w, st_w = RX.slstm_forward(p, rcfg, jnp.asarray(x1), state=st_w)
    y_g, st_g = X.slstm_forward(mod, cfg, torch.from_numpy(x1), state=st_g)
    _close(y_g, y_w)
    for g, w in zip(st_g, st_w):
        _close(g, w)


def test_recurrent_state_initializers_match():
    rcfg, cfg = _cfgs("xlstm-1.3b")
    for got, want in ((X.init_mlstm_state(cfg, 3, "cpu"),
                       RX.init_mlstm_state(rcfg, 3)),
                      (X.init_slstm_state(cfg, 3, "cpu"),
                       RX.init_slstm_state(rcfg, 3))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert np.array_equal(g.numpy(), np.asarray(w))
    rcfg, cfg = _cfgs("jamba-v0.1-52b", "bfloat16")
    for g, w in zip(S.init_state(cfg, 3, torch.bfloat16, "cpu"),
                    RS.init_state(rcfg, 3)):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).endswith(str(w.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches(dtype):
    """Cross K/V from bf16 patches (widened in an f32 model, as JAX
    promotes them) and the query side over them: non-causal, no rope."""
    rcfg, cfg = _cfgs("llama-3.2-vision-11b", dtype)
    rblk = jax.tree.map(lambda a: a[0],
                        rlm.init(jax.random.key(0), rcfg)["blocks"][0])
    attn = _module(lm.Attention, cfg, rblk["mixer"])
    patches = jnp.asarray(_x((2, cfg.cross_kv_tokens, cfg.d_model), 1),
                          jnp.bfloat16)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(_x((2, 7, cfg.d_model), 2), jdt)
    kv_w = RL.cross_kv(rblk["mixer"], rcfg, patches)
    kv_g = L.cross_kv(attn, cfg, _t(patches))
    tol = 1e-6 if dtype == "float32" else 2e-2
    for g, w in zip(kv_g, kv_w):
        assert g.dtype == L.dtype_of(cfg)
        _close(g, w, tol)
    y_w = RL.cross_attention_cached(rblk["mixer"], rcfg, x, kv_w)
    y_g = L.cross_attention_cached(attn, cfg, _t(x), kv_g)
    _close(y_g, y_w, tol)


def test_gelu_mlp_matches_the_tanh_approximation():
    """whisper's MLP: ``jax.nn.gelu`` is the tanh form by default, torch's
    the erf form; the port must take the tanh form."""
    rcfg, cfg = _cfgs("whisper-tiny")
    rp = RL.ffn_init(jax.random.key(0), rcfg)
    ffn = _module(lm.FFN, cfg, rp)
    assert ffn.wg is None
    x = _x((2, 5, cfg.d_model), 4) * 3
    want = RL.ffn_apply(rp, jnp.asarray(x), "gelu")
    _close(L.ffn_apply(ffn, torch.from_numpy(x), "gelu"), want, 1e-6)
    z = torch.linspace(-6, 6, 1001)
    np.testing.assert_allclose(L.gelu(z).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z))),
                               atol=1e-6)
    assert float((F.gelu(z) - L.gelu(z)).abs().max()) > 1e-4
