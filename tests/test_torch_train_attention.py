"""The attention gradient that training runs, held against the reference.

The reference trains through ``_xla_attention`` (its TPU kernel has no
backward), so the port's gradient is held against ``jax.grad`` of that
function: on the CPU ``ops.flash_attention`` is the plain ``ref.mha_prefill``
and autograd differentiates it; ``ref.flash_attention_backward_ref`` is the
same gradient as a function, the plain version the card's backward kernels
are held against in ``chip_smoke.py``.

The CUDA backward (``csrc/flash_attention_bwd.cu``) cannot run here, so its
two routes' orders of operations are rehearsed in plain torch. The f32
route (:func:`_tiled_backward`): tiles of ``flash_attention.BWD_TILE``
query rows and keys, P recomputed from the forward's lse, D = rowsum(dO o
O) from the first kernel, dQ over the key tiles up to the diagonal, dK and
dV per key tile over the group's query heads and their tiles from the
diagonal on (GQA summed in the block), rows past S never read, and a row
with lse = +inf (it met no key) contributing nothing. The bf16 route
(:func:`_tiled_backward_bf16`): the same walk in tiles of
``flash_attention.BWD_WGMMA_TILE``, the dk/dv products computed transposed
(keys as rows), P and dS rounded to bf16 before their products, and dS set
to 0 on a row that sees one key. Tolerances: f32, 1e-5 × max|g| of each
gradient (one order of summation against another); bf16, the card's 2e-2
× max|g| (``chip_smoke.BWD_TOL``: bf16 inputs, outputs, P and dS against
f32 math), and exactly 0 where the plain gradient is.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import flash_attention, ops, ref

REPO = Path(__file__).resolve().parent.parent

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


LOG2E = 1.4426950408889634
#: the bf16 tolerance of each gradient, × its max|g| (as on the card)
BF16_TOL = 2e-2


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _p_ds_bf16(s, dp, lse, dd, valid, lone, scale_log2):
    """P and dS of one tile pair as the tensor-core kernels compute them,
    for rows r and columns c of ``s`` (S or S^T): P = exp2(s scale log2e -
    lse log2e), -inf added to the exponent where not ``valid``, rounded to
    bf16; dS = P (dP - D), times 0 where ``lone`` (a q row that sees one
    key), rounded to bf16. ``lse`` and ``dd`` broadcast against ``s``."""
    hide = torch.where(valid, 0.0, float("-inf"))
    p = _bf16_round(torch.exp2(s * scale_log2 - lse * LOG2E + hide))
    ds = p * (dp - dd) * torch.where(lone, 0.0, 1.0)
    return p, _bf16_round(ds)


def _tiled_backward_bf16(q, k, v, o, do, lse, causal, groups=2):
    """The bf16 backward kernels' arithmetic (``flash_bwd_dq_wgmma`` then
    ``flash_bwd_dkdv_wgmma``), tile by tile: (dq, dk, dv) bf16 (B, H, S, D)
    and D (B, Hq, S) f32. Products in f32 of bf16 values, as the tensor
    cores sum them. The dk/dv walk over (head, q tile) steps is dealt to
    ``groups`` warpgroups in turns (the kernel's two by default), each
    summing its own, and the first adds the others' at the end."""
    T = flash_attention.BWD_WGMMA_TILE
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = torch.tensor(1 / math.sqrt(D), dtype=torch.float32)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
    dq = torch.zeros((B, Hq, S, D), dtype=torch.bfloat16)
    dk = torch.zeros((B, Hkv, S, D), dtype=torch.bfloat16)
    dv = torch.zeros((B, Hkv, S, D), dtype=torch.bfloat16)
    dsum = torch.zeros((B, Hq, S))
    nt = -(-S // T)
    idx = torch.arange(T)

    def lone(rows):
        # a q row that sees one key: causal row 0, or every row when S = 1
        return rows == 0 if causal else torch.full_like(rows, S == 1,
                                                        dtype=torch.bool)

    # kernel 1: one block per (64-row q tile, q head, batch row)
    for b in range(B):
        for h in range(Hq):
            for qt in range(nt):
                q0 = qt * T
                rows = q0 + idx
                Qt, dOt, Ot = (_tile(x[b, h], q0, T, S) for x in (q, do, o))
                Dd = (dOt * Ot).sum(-1)
                # a row past S gets lse = +inf: P = 0
                lse_t = torch.where(rows < S, _tile(lse[b, h][:, None], q0,
                                                    T, S)[:, 0], float("inf"))
                n = min(T, S - q0)
                dsum[b, h, q0:q0 + n] = Dd[:n]
                acc = torch.zeros((T, D))
                k_end = min(q0 + T, S) if causal else S
                for k0 in range(0, k_end, T):
                    Kt, Vt = (_tile(x[b, h // G], k0, T, S) for x in (k, v))
                    keys = k0 + idx
                    valid = (keys[None, :] < S) & (
                        ~torch.tensor(causal) | (keys[None, :] <= rows[:, None]))
                    _, ds = _p_ds_bf16(Qt @ Kt.T, dOt @ Vt.T, lse_t[:, None],
                                       Dd[:, None], valid,
                                       lone(rows)[:, None], scale_log2)
                    acc += ds @ Kt
                dq[b, h, q0:q0 + n] = (acc * scale)[:n].to(torch.bfloat16)
    # kernel 2: one block per (64-key tile, kv head, batch row), keys as
    # the rows of every product
    for b in range(B):
        for hk in range(Hkv):
            for kt in range(nt):
                k0 = kt * T
                keys = k0 + idx
                Kt, Vt = (_tile(x[b, hk], k0, T, S) for x in (k, v))
                steps = [(hk * G + g, q0) for g in range(G)
                         for q0 in range(k0 if causal else 0, S, T)]
                sums = []
                for w in range(groups):
                    adk = torch.zeros((T, D))
                    adv = torch.zeros((T, D))
                    for h, q0 in steps[w::groups]:
                        rows = q0 + idx
                        Qt, dOt = (_tile(x[b, h], q0, T, S) for x in (q, do))
                        # zeros past S, as the 4-byte copies leave them
                        lse_t = _tile(lse[b, h][:, None], q0, T, S)[:, 0]
                        Dd = _tile(dsum[b, h][:, None], q0, T, S)[:, 0]
                        valid = (rows[None, :] < S) & (
                            ~torch.tensor(causal)
                            | (keys[:, None] <= rows[None, :]))
                        pT, dsT = _p_ds_bf16(Kt @ Qt.T, Vt @ dOt.T,
                                             lse_t[None, :], Dd[None, :],
                                             valid, lone(rows)[None, :],
                                             scale_log2)
                        adv += pT @ dOt
                        adk += dsT @ Qt
                    sums.append((adk, adv))
                adk, adv = sums[0]
                for bk, bv in sums[1:]:
                    adk, adv = adk + bk, adv + bv
                n = min(T, S - k0)
                dk[b, hk, k0:k0 + n] = (adk * scale)[:n].to(torch.bfloat16)
                dv[b, hk, k0:k0 + n] = adv[:n].to(torch.bfloat16)
    return dq, dk, dv, dsum


def _bf16_inputs(B, Hq, Hkv, S, D, seed):
    """q, k, v, dO as bf16 (B, H, S, D) views of (B, S, H, D) buffers."""
    return [_bhsd(torch.from_numpy(x).to(torch.bfloat16))
            for x in _inputs(B, Hq, Hkv, S, D, seed)]


def _close_bf16(got, want):
    """Within BF16_TOL × max|g|, and exactly 0 where the plain gradient is
    0 everywhere (S = 1's dq and dk)."""
    assert got.dtype == want.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if scale == 0:
        assert err == 0, err
    else:
        assert err <= BF16_TOL * scale, (err, scale)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", CASES)
def test_tiled_bf16_backward_arithmetic_matches_plain(B, Hq, Hkv, S, D,
                                                      causal):
    """The tensor-core route's order of operations (64-row tiles, the dk/dv
    products transposed, P and dS rounded to bf16, the one-key rule) within
    the bf16 tolerance of ``ref.flash_attention_backward_ref``; S = 1's dq
    and dk exactly 0."""
    q, k, v, do = _bf16_inputs(B, Hq, Hkv, S, D, seed=4)
    o = ref.mha_prefill(q, k, v, causal)
    want = ref.flash_attention_backward_ref(q, k, v, o, do, causal)
    got = _tiled_backward_bf16(q, k, v, o, do,
                               _lse(q.float(), k.float(), causal), causal)
    for g, w in zip(got[:3], want):
        _close_bf16(g, w)
    torch.testing.assert_close(got[3], (do.float() * o.float()).sum(-1))


@pytest.mark.parametrize("junk", [999.0, float("nan")])
def test_tiled_bf16_backward_never_reads_past_s(junk):
    """The bf16 route's twin of the junk test: inputs that are the first S
    rows of longer buffers filled with ±999 or NaN give the gradients of
    clean inputs bit for bit."""
    B, Hq, Hkv, S, D = 1, 4, 2, 77, 32
    clean = _bf16_inputs(B, Hq, Hkv, S, D, seed=5)
    bufs = []
    for i, x in enumerate(clean):
        buf = torch.full((B, x.shape[1], S + 27, D), junk if i % 2 else -junk,
                         dtype=torch.bfloat16)
        buf[:, :, :S] = x
        bufs.append(buf[:, :, :S])
    for causal in (True, False):
        outs = []
        for q, k, v, do in (clean, bufs):
            o = ref.mha_prefill(q, k, v, causal)
            outs.append(_tiled_backward_bf16(
                q, k, v, o, do, _lse(q.float(), k.float(), causal), causal))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_tiled_bf16_backward_no_key_and_one_key_rows():
    """A row whose lse is +inf gets P = dS = 0 (dq zero, nothing added to
    dk and dv, no NaN); a row that sees one key gets dS = 0 by the one-key
    rule, so causal row 0's dq is exactly 0, and S = 1 gives dq = dk = 0
    exactly and dv = dO."""
    B, Hq, Hkv, S, D = 1, 2, 1, 70, 16
    q, k, v, do = _bf16_inputs(B, Hq, Hkv, S, D, seed=6)
    o = ref.mha_prefill(q, k, v, True)
    lse = _lse(q.float(), k.float(), True)
    lse[0, 1, 66] = float("inf")
    do2 = do.clone()
    do2[0, 1, 66] = 0.0                      # as if row 66 of head 1 were gone
    dq, dk, dv, _ = _tiled_backward_bf16(q, k, v, o, do, lse, True)
    assert all(torch.isfinite(t.float()).all() for t in (dq, dk, dv))
    assert not dq[0, 1, 66].any()
    assert not dq[:, :, 0].any()             # causal row 0 sees one key
    _, dk2, dv2, _ = _tiled_backward_bf16(q, k, v, o, do2, lse, True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    for causal in (False, True):
        q, k, v, do = _bf16_inputs(1, 4, 2, 1, 16, seed=7)
        o = ref.mha_prefill(q, k, v, causal)
        dq, dk, dv, _ = _tiled_backward_bf16(
            q, k, v, o, do, _lse(q.float(), k.float(), causal), causal)
        assert not dq.any() and not dk.any()
        torch.testing.assert_close(dv.float(), (do[:, 0::2] + do[:, 1::2])
                                   .float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("S,causal", [(128, True), (130, False), (64, True)])
def test_tiled_bf16_backward_two_warpgroups(S, causal):
    """dk/dv's walk dealt to the kernel's two warpgroups and merged in
    order: dq and D the same bits as with one warpgroup's walk, dk and dv
    within the bf16 tolerance of the plain gradient."""
    q, k, v, do = _bf16_inputs(1, 4, 2, S, 64, seed=8)
    o = ref.mha_prefill(q, k, v, causal)
    lse = _lse(q.float(), k.float(), causal)
    one = _tiled_backward_bf16(q, k, v, o, do, lse, causal, groups=1)
    two = _tiled_backward_bf16(q, k, v, o, do, lse, causal, groups=2)
    assert torch.equal(one[0], two[0]) and torch.equal(one[3], two[3])
    want = ref.flash_attention_backward_ref(q, k, v, o, do, causal)
    for g, w in zip(two[1:3], want[1:]):
        _close_bf16(g, w)


def test_backward_ab_reads_ptxas_and_finds_sources(tmp_path):
    """The A/B script beside ``chip_smoke.py`` (``flash_ab.py``): a side's
    sources from its checkout root, kernels named from their mangled
    names, ``-Xptxas -v``'s registers and spills by kernel, and SASS hashed
    by kernel with the anonymous namespace's per-build hash left out."""
    spec = importlib.util.spec_from_file_location("flash_ab",
                                                  REPO / "flash_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    from repro_torch.kernels import _build
    assert ab.csrc_of(REPO) == _build.CSRC
    with pytest.raises(FileNotFoundError):
        ab.csrc_of(tmp_path)
    ns = "_ZN55_GLOBAL__N__{}_22_flash_attention_bwd_cu_01debb19"
    dkdv = ns.format("3b49a283") + ("20flash_bwd_dkdv_wgmmaILi128EEEvPK13"
                                    "__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_")
    dq = ns.format("3b49a283") + "19flash_bwd_dq_kernelEPKfS1_S1_S1_S1_"
    fwd = ("_ZN55_GLOBAL__N__3b49a283_18_flash_attention_cu_01debb1928"
           "flash_attention_kernel_wgmmaILi64ELi2EEEvPK13__nv_bfloat16")
    assert ab.kernel_label(dkdv) == "flash_bwd_dkdv_wgmma<128>"
    assert ab.kernel_label(dq) == "flash_bwd_dq_kernel"
    assert ab.kernel_label(fwd) == "flash_attention_kernel_wgmma<64, 2>"
    assert ab.kernel_label("_ZN4repro11other_kernelEv") is None
    head = "ptxas info    : Compiling entry function '{}' for 'sm_90a'"
    report = "\n".join([
        head.format(dkdv),
        "ptxas info    : Function properties for " + dkdv,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 244 registers, used 16 barriers",
        head.format(dq),
        "ptxas info    : (C7515) Potential Performance Loss: wgmma serialized",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers"])
    assert ab.ptxas_stats(report) == {
        "flash_bwd_dkdv_wgmma<128>": {"registers": 244, "spill_stores": 0,
                                      "spill_loads": 0, "notes": []},
        "flash_bwd_dq_kernel": {
            "registers": 64, "spill_stores": 4, "spill_loads": 8,
            "notes": ["ptxas info    : (C7515) Potential Performance Loss: "
                      "wgmma serialized"]}}

    def listing(ns_hash, op):
        return "\n".join([
            "\t\tFunction : " + fwd.replace("3b49a283", ns_hash),
            '\t.headerflags\t@"EF_CUDA_SM90"',
            "  /*0000*/ LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */",
            "                                  /* 0x000e620000000800 */",
            f"  /*0010*/ {op} ; /* 0x0000000000187919 */",
            "\t\t..........",
            "\t\tFunction : " + dq,
            "  /*0000*/ EXIT ; /* 0x000000000000794d */"])
    a = ab.sass_hashes(listing("3b49a283", "S2R R24, SR_CTAID.Y"))
    b = ab.sass_hashes(listing("76b450a1", "S2R R24, SR_CTAID.Y"))
    c = ab.sass_hashes(listing("3b49a283", "S2R R24, SR_CTAID.Z"))
    assert set(a) == {"flash_attention_kernel_wgmma<64, 2>",
                      "flash_bwd_dq_kernel"}
    assert ab.sass_compared(a, b) == {k: True for k in a}
    assert ab.sass_compared(a, c) == {"flash_attention_kernel_wgmma<64, 2>":
                                      False, "flash_bwd_dq_kernel": True}
    del c["flash_bwd_dq_kernel"]
    assert ab.sass_compared(a, c)["flash_bwd_dq_kernel"] is False


def test_backward_route_by_dtype():
    """bf16 backward runs on the tensor cores, f32 on the CUDA cores; the
    tiles follow the route; any other type is refused."""
    assert flash_attention.backward_route(torch.bfloat16) == "wgmma"
    assert flash_attention.backward_route(torch.float32) == "cuda_cores"
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            flash_attention.backward_route(dt)
    assert (flash_attention.BWD_TILE, flash_attention.BWD_WGMMA_TILE) == (
        32, 64)


def test_backward_wrapper_takes_cuda_tensors_only():
    q = torch.rand(1, 2, 5, 16)
    kv = torch.rand(1, 1, 5, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_backward_cuda(
            q, kv, kv, q, torch.zeros(1, 2, 5), q, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_lse_cuda(q, kv, kv)
    assert flash_attention.BWD_KERNELS == 2
