"""The training loss and its gradients in the port against the reference's,
for every model family: ``lm.loss_fn`` (remat on, as the trainer runs it)
against ``jax.value_and_grad(repro.models.lm.loss_fn)`` at each config's
``smoke()`` widths in f32, from the reference's ``lm.init`` weights carried
over by ``convert.lm_params_from_numpy``. Depth is cut to 2 layers, or to
one period of the block pattern where a period is longer; tokens, labels
(some masked with -1), frames and patches are made with numpy from a seed.

Tolerances (f32): the loss and nll within 1e-5 relative (the aux loss
within 1e-5 absolute), and every gradient leaf within 1e-4 × its max|g| —
one f32 reduction order against another, through a backward pass whose
sums run in other orders than the reference's jitted ones. xLSTM's within
1e-3 × max|g|: its gradient is ill-conditioned in the weights. Scaling the
reference's own weights by 1 + 1e-7 N(0, 1) (about one f32 ulp) moves its
embedding gradient by 7.2e-5 × max|g|, and by 1e-6 N(0, 1) by 2.5e-3; the
port's rounding gives 3.0e-4, while each mLSTM and sLSTM layer alone
agrees within 3e-6. MoE configs
must drop the same (token, choice) assignments as the reference (the
capacity depends on every token), which ``moe.ROUTING`` and the
reference's routing choices show.
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
from repro_torch.configs import all_ids, get
from repro_torch.convert import lm_named_from_numpy, lm_params_from_numpy
from repro_torch.kernels import flash_attention
from repro_torch.models import lm, moe

B, S = 2, 24
_GRAD_TOL = {"xlstm-1.3b": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg):
    return dataclasses.replace(cfg, dtype="float32",
                               n_layers=max(2, len(cfg.pattern)))


@functools.lru_cache(maxsize=None)
def _ref_grads(name):
    """(reference cfg, params, batch (numpy), loss, aux, grads), f32."""
    rcfg = _cut(ref_get(name).smoke())
    params = rlm.init(jax.random.key(0), rcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    if rcfg.family in ("audio", "vlm"):
        key = "frames" if rcfg.family == "audio" else "patches"
        x = rng.standard_normal((B, rcfg.cross_kv_tokens, rcfg.d_model))
        batch[key] = np.asarray(jnp.asarray(x, jnp.bfloat16))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: rlm.loss_fn(p, rcfg, b, remat=True), has_aux=True))
    (loss, aux), grads = fn(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return (rcfg, jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in aux.items()},
            jax.tree.map(np.asarray, grads))


def _port_batch(batch):
    out = {}
    for k, v in batch.items():
        if v.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.astype(np.int64))
    return out


@pytest.mark.parametrize("name", all_ids())
def test_loss_and_grads_match_reference(name):
    rcfg, params_np, batch, ref_loss, ref_aux, ref_grads = _ref_grads(name)
    cfg = _cut(get(name).smoke())
    model = lm_params_from_numpy(params_np, cfg, "cpu")
    model.requires_grad_(True)
    before = flash_attention.LAUNCHES
    moe.ROUTING = []
    try:
        loss, aux = lm.loss_fn(model, cfg, _port_batch(batch), remat=True)
        drops = sum(int(d) for _, d in moe.ROUTING)
    finally:
        moe.ROUTING = None
    loss.backward()
    assert flash_attention.LAUNCHES == before
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(float(aux["nll"]), ref_aux["nll"], rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"]), ref_aux["aux"], atol=1e-5)
    if cfg.moe is not None:
        assert float(aux["aux"]) > 0
        assert drops == _ref_drops(name, rcfg, params_np, batch)
    want = lm_named_from_numpy(ref_grads, cfg, model)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for k, p in params.items():
        g, w = p.grad.numpy(), want[k]
        assert g.shape == w.shape, k
        tol = _GRAD_TOL.get(name, 1e-4) * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


def _ref_drops(name, rcfg, params_np, batch):
    """Dropped (token, choice) assignments of the reference's forward."""
    from repro.models import moe as rmoe
    drops = []
    orig = rmoe.moe_apply

    def spy(p, cfg, x):
        T = x.shape[0] * x.shape[1]
        logits = x.reshape(T, -1).astype(jnp.float32) @ p["router"]["w"]
        _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                 cfg.moe.top_k)
        counts = np.bincount(np.asarray(top_e).reshape(-1),
                             minlength=cfg.moe.n_experts)
        drops.append(int(np.maximum(counts - rmoe.capacity(cfg, T),
                                    0).sum()))
        return orig(p, cfg, x)

    rmoe.moe_apply = spy
    try:
        # eager (no scan, no remat), so the spy sees concrete arrays
        rlm.train_logits(jax.tree.map(jnp.asarray, params_np), rcfg,
                         {k: jnp.asarray(v) for k, v in batch.items()
                          if k != "labels"}, remat=False, unroll=True)
    finally:
        rmoe.moe_apply = orig
    return sum(drops)
