"""The attention gradient that training runs, held against the reference.

The reference trains through ``_xla_attention`` (its TPU kernel has no
backward), so the port's gradient is held against ``jax.grad`` of that
function: on the CPU ``ops.flash_attention`` is the plain ``ref.mha_prefill``
and autograd differentiates it; ``ref.flash_attention_backward_ref`` is the
same gradient as a function, the plain version the card's backward kernels
are held against in ``chip_smoke.py``.

The CUDA backward (``csrc/flash_attention_bwd.cu``) cannot run here, so its
order of operations is rehearsed in plain torch (:func:`_tiled_backward`):
tiles of ``flash_attention.BWD_TILE`` query rows and keys, P recomputed
from the forward's lse, D = rowsum(dO o O) from the first kernel, dQ over
the key tiles up to the diagonal, dK and dV per key tile over the group's
query heads and their tiles from the diagonal on (GQA summed in the block),
rows past S never read, and a row with lse = +inf (it met no key)
contributing nothing. Tolerances: f32, 1e-5 × max|g| of each gradient (one
order of summation against another).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import flash_attention, ops, ref

# (B, Hq, Hkv, S, D, causal): GQA groups 1, 2, 4, 5, 6; head dims 64, 80,
# 128; S 1, ragged and exact tiles
CASES = [(2, 4, 2, 17, 64, True), (1, 6, 1, 33, 80, False),
         (1, 4, 4, 1, 64, False), (1, 4, 4, 1, 64, True),
         (2, 16, 8, 64, 128, True), (1, 5, 1, 40, 64, True),
         (1, 8, 2, 65, 32, False)]


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES)
    yield
    assert (flash_attention.LAUNCHES,
            flash_attention.BWD_LAUNCHES) == before


def _inputs(B, Hq, Hkv, S, D, seed=0):
    """q, k, v and the output gradient dO, (B, S, H, D) f32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv, Hq)]


def _leaf(x):
    return torch.from_numpy(x).requires_grad_(True)


def _bhsd(t):
    return t.transpose(1, 2)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", CASES)
def test_autograd_matches_reference_xla_gradient(B, Hq, Hkv, S, D, causal):
    q, k, v, do = _inputs(B, Hq, Hkv, S, D)

    def f(q, k, v):
        return jnp.sum(RL._xla_attention(q, k, v, causal) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_leaf(x) for x in (q, k, v)]
    out = _bhsd(ops.flash_attention(*map(_bhsd, leaves), causal=causal))
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w)
    # the plain backward is that gradient, in (B, H, S, D)
    got = ref.flash_attention_backward_ref(
        *(_bhsd(t.detach()) for t in leaves), _bhsd(out.detach()),
        _bhsd(torch.from_numpy(do)), causal)
    for g, t in zip(got, leaves):
        assert torch.equal(_bhsd(g), t.grad)


def test_model_gradient_flows_through_attention_in_its_layout():
    """Gradients of (B, S, H, D) projections read as (B, H, S, D) views
    come back in the projections' layout, and bf16 inputs give bf16
    gradients."""
    q, k, v, do = _inputs(1, 4, 2, 9, 16)
    for dt in (torch.float32, torch.bfloat16):
        leaves = [torch.from_numpy(x).to(dt).requires_grad_(True)
                  for x in (q, k, v)]
        out = ops.flash_attention(*map(_bhsd, leaves), causal=True)
        out.backward(_bhsd(torch.from_numpy(do).to(dt)))
        for t in leaves:
            assert t.grad.dtype == dt and t.grad.shape == t.shape
            assert torch.isfinite(t.grad).all()


def _lse(q, k, causal):
    """The forward's saved log-sum-exp, (B, Hq, S) f32."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(G, dim=1)) * D ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    return torch.logsumexp(s, dim=-1)


def _tile(x, r0, T, S):
    """Rows r0 .. r0 + T - 1 of (S, D) ``x``, zeros past S (never read)."""
    out = torch.zeros((T, x.shape[-1]), dtype=torch.float32)
    n = max(0, min(T, S - r0))
    out[:n] = x[r0:r0 + n].to(torch.float32)
    return out


def _seqdot(a, b):
    """Sum over the last axis of a * b, one element after another, the
    order in which the kernels sum dP and D: where a row of O is a row of
    V (one visible key), dP - D is then exactly 0."""
    x = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1])
    for d in range(a.shape[-1]):
        x = x + a[..., d] * b[..., d]
    return x


def _pairs(Qt, dOt, Kt, Vt, lse_t, Dd, q0, k0, S, causal, scale):
    """P and dS of one (q tile, key tile) pair, as ``pairs`` in the
    kernel: zero where masked, past S or where lse is +inf."""
    T = Qt.shape[0]
    row = q0 + torch.arange(T)[:, None]
    key = k0 + torch.arange(T)[None, :]
    valid = (row < S) & (key < S)
    if causal:
        valid &= key <= row
    s = (Qt @ Kt.T) * scale
    p = torch.where(valid, torch.exp(s - lse_t[:, None]), 0.0)
    dp = _seqdot(dOt[:, None], Vt[None])
    ds = torch.where(valid, p * (dp - Dd[:, None]), 0.0)
    return p, ds


def _tiled_backward(q, k, v, o, do, lse, causal, T=None):
    """The two backward kernels' arithmetic, tile by tile: (dq, dk, dv)
    (B, H, S, D) f32 and D (B, Hq, S)."""
    T = T or flash_attention.BWD_TILE
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = D ** -0.5
    dq = torch.zeros((B, Hq, S, D))
    dk = torch.zeros((B, Hkv, S, D))
    dv = torch.zeros((B, Hkv, S, D))
    dsum = torch.zeros((B, Hq, S))
    nt = -(-S // T)
    # kernel 1: one block per (q tile, q head, batch row)
    for b in range(B):
        for h in range(Hq):
            for qt in range(nt):
                q0 = qt * T
                Qt, dOt, Ot = (_tile(x[b, h], q0, T, S) for x in (q, do, o))
                Dd = _seqdot(dOt, Ot)
                lse_t = _tile(lse[b, h][:, None], q0, T, S)[:, 0]
                n = min(T, S - q0)
                dsum[b, h, q0:q0 + n] = Dd[:n]
                acc = torch.zeros((T, D))
                k_end = min(q0 + T, S) if causal else S
                for k0 in range(0, k_end, T):
                    Kt, Vt = (_tile(x[b, h // G], k0, T, S) for x in (k, v))
                    _, ds = _pairs(Qt, dOt, Kt, Vt, lse_t, Dd, q0, k0, S,
                                   causal, scale)
                    acc += ds @ Kt
                dq[b, h, q0:q0 + n] = (acc * scale)[:n]
    # kernel 2: one block per (key tile, kv head, batch row)
    for b in range(B):
        for hk in range(Hkv):
            for kt in range(nt):
                k0 = kt * T
                Kt, Vt = (_tile(x[b, hk], k0, T, S) for x in (k, v))
                adk = torch.zeros((T, D))
                adv = torch.zeros((T, D))
                for g in range(G):
                    h = hk * G + g
                    for q0 in range(k0 if causal else 0, S, T):
                        Qt, dOt = (_tile(x[b, h], q0, T, S) for x in (q, do))
                        lse_t = _tile(lse[b, h][:, None], q0, T, S)[:, 0]
                        Dd = _tile(dsum[b, h][:, None], q0, T, S)[:, 0]
                        p, ds = _pairs(Qt, dOt, Kt, Vt, lse_t, Dd, q0, k0, S,
                                       causal, scale)
                        adv += p.T @ dOt
                        adk += ds.T @ Qt
                n = min(T, S - k0)
                dk[b, hk, k0:k0 + n] = (adk * scale)[:n]
                dv[b, hk, k0:k0 + n] = adv[:n]
    return dq, dk, dv, dsum


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", CASES)
@pytest.mark.parametrize("T", [None, 64])
def test_tiled_backward_arithmetic_matches_autograd(B, Hq, Hkv, S, D, causal,
                                                    T):
    q, k, v, do = (_bhsd(torch.from_numpy(x))
                   for x in _inputs(B, Hq, Hkv, S, D, seed=1))
    o = ref.mha_prefill(q, k, v, causal)
    want = ref.flash_attention_backward_ref(q, k, v, o, do, causal)
    got = _tiled_backward(q, k, v, o, do, _lse(q, k, causal), causal, T)
    for g, w in zip(got[:3], want):
            _close(g, w.numpy())
    torch.testing.assert_close(got[3], (do * o).sum(-1))


@pytest.mark.parametrize("junk", [999.0, float("nan")])
def test_tiled_backward_never_reads_past_s(junk):
    """Inputs that are the first S rows of longer buffers filled with junk
    past S (±999, NaN): the gradients are bit for bit those of clean
    inputs."""
    B, Hq, Hkv, S, D = 1, 4, 2, 37, 32
    clean = [_bhsd(torch.from_numpy(x)) for x in _inputs(B, Hq, Hkv, S, D)]
    bufs = []
    for i, x in enumerate(clean):
        buf = torch.full((B, x.shape[1], S + 27, D), junk if i % 2 else -junk)
        buf[:, :, :S] = x
        bufs.append(buf[:, :, :S])
    for causal in (True, False):
        outs = []
        for q, k, v, do in (clean, bufs):
            o = ref.mha_prefill(q, k, v, causal)
            outs.append(_tiled_backward(q, k, v, o, do, _lse(q, k, causal),
                                        causal))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_tiled_backward_rows_that_met_no_key_give_zero():
    """A row whose lse is +inf (the forward writes that for l = 0) gets P =
    0 and dS = 0: its dq is zero, it adds nothing to dk and dv, and no NaN
    appears; a non-causal S of 1 (one key) gives dq = dk = 0 exactly."""
    B, Hq, Hkv, S, D = 1, 2, 1, 20, 16
    q, k, v, do = (_bhsd(torch.from_numpy(x))
                   for x in _inputs(B, Hq, Hkv, S, D, seed=2))
    o = ref.mha_prefill(q, k, v, True)
    lse = _lse(q, k, True)
    lse[0, 1, 7] = float("inf")
    do2 = do.clone()
    do2[0, 1, 7] = 0.0                       # as if row 7 of head 1 were gone
    dq, dk, dv, _ = _tiled_backward(q, k, v, o, do, lse, True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[0, 1, 7].any()
    _, dk2, dv2, _ = _tiled_backward(q, k, v, o, do2, lse, True)
    torch.testing.assert_close(dk, dk2)
    torch.testing.assert_close(dv, dv2)
    # one key: P = 1, dP - D = 0
    q, k, v, do = (_bhsd(torch.from_numpy(x))
                   for x in _inputs(1, 2, 2, 1, 16, seed=3))
    o = ref.mha_prefill(q, k, v, False)
    dq, dk, dv, _ = _tiled_backward(q, k, v, o, do, _lse(q, k, False), False)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, do)


def test_backward_wrapper_takes_cuda_tensors_only():
    q = torch.rand(1, 2, 5, 16)
    kv = torch.rand(1, 1, 5, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_backward_cuda(
            q, kv, kv, q, torch.zeros(1, 2, 5), q, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_lse_cuda(q, kv, kv)
    assert flash_attention.BWD_KERNELS == 2
