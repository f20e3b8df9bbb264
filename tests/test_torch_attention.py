"""The attention kernels' plain versions, held against the reference.

``repro_torch.kernels.ref.mha_prefill`` and ``ref.gqa_decode`` are what a
CPU tensor runs and what ``chip_smoke.py`` holds the CUDA kernels against on
the card. Here the same numpy inputs go through them, through the JAX
package's jnp oracles, and through its Pallas kernels in interpret mode, on
the shapes of ``tests/test_kernels.py``; tolerance 2e-5 in f32 and 2e-2 in
bf16, as there. ``ref.paged_gqa_decode`` is held against the Pallas paged
kernel in both pool layouts, and ``ref.mha_prefill_extend`` against the
reference's ``_xla_attention`` with ``q_offset`` and the bucketed mask. The decode cases add what the engine relies on: garbage past
``kv_len`` changes nothing, ``kv_len`` past Smax attends the whole cache, and
``kv_len == 0`` gives zeros (the TPU kernel's answer; the jnp oracle's is
NaN).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as rdec
import repro.kernels.flash_attention as rfa
import repro.kernels.paged_attention as rpaged
from repro.kernels import ref as rref
from repro.models import layers as RL
from repro_torch.kernels import (decode_attention, flash_attention, ops,
                                 paged_attention, ref)

FA_CASES = [
    # (B, Hq, Hkv, S, D, block_q, block_k), as tests/test_kernels.py
    (1, 4, 4, 128, 64, 64, 64),
    (2, 8, 2, 256, 64, 128, 128),
    (1, 8, 1, 128, 128, 64, 32),
    (1, 2, 2, 64, 32, 64, 64),
    (2, 4, 2, 512, 64, 128, 256),
]
DEC_CASES = [
    # (B, Hq, Hkv, Smax, D, block_k), as tests/test_kernels.py
    (1, 8, 8, 256, 64, 128),
    (2, 8, 2, 512, 64, 128),
    (1, 32, 8, 1024, 128, 256),
    (3, 4, 1, 128, 32, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(x: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype`` (both
    round f32 to bf16 to nearest even, so the bits agree)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _fa_inputs(B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(S * 7 + Hq)
    return [_both(rng.standard_normal(shp).astype(np.float32), dtype)
            for shp in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,bq,bk", FA_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mha_prefill_matches_reference(B, Hq, Hkv, S, D, bq, bk, causal,
                                       dtype):
    (qj, qt), (kj, kt), (vj, vt) = _fa_inputs(B, Hq, Hkv, S, D, dtype)
    tol = DTYPES[dtype][2]
    got = ref.mha_prefill(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, rref.mha_prefill(qj, kj, vj, causal=causal), tol)
    _close(got, rfa.flash_attention(qj, kj, vj, causal=causal, block_q=bq,
                                    block_k=bk, interpret=True), tol)


def test_mha_prefill_ragged_length_and_strided_inputs():
    """Any S works (the CUDA kernel masks its ragged tiles; the plain
    version has no tiles), and (B, S, H, D) projections transposed to
    (B, H, S, D) views give the same answer as contiguous inputs."""
    rng = np.random.default_rng(3)
    for S in (1, 17, 200):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, S, h, 32))
                                    .astype(np.float32)) for h in (4, 2, 2))
        got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
        want = rref.mha_prefill(*(jnp.asarray(t.transpose(1, 2).numpy())
                                  for t in (q, k, v)), causal=True)
        _close(got, want, 2e-5)


def _dec_inputs(B, Hq, Hkv, Smax, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shp).astype(np.float32)
            for shp in ((B, Hq, D), (B, Hkv, Smax, D), (B, Hkv, Smax, D))]
    kv_len = rng.integers(1, Smax + 1, B).astype(np.int32)
    return [_both(a, dtype) for a in arrs], kv_len


@pytest.mark.parametrize("B,Hq,Hkv,Smax,D,bk", DEC_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gqa_decode_matches_reference(B, Hq, Hkv, Smax, D, bk, dtype):
    ((qj, qt), (kj, kt), (vj, vt)), kv_len = _dec_inputs(
        B, Hq, Hkv, Smax, D, dtype, Smax + Hq)
    tol = DTYPES[dtype][2]
    got = ref.gqa_decode(qt, kt, vt, torch.from_numpy(kv_len))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, rref.gqa_decode(qj, kj, vj, jnp.asarray(kv_len)), tol)
    _close(got, rdec.gqa_decode_attention(qj, kj, vj, jnp.asarray(kv_len),
                                          block_k=bk, interpret=True), tol)


@pytest.mark.parametrize("garbage", [999.0, -999.0, float("nan")])
def test_gqa_decode_ignores_cache_past_kv_len(garbage):
    """What lies past kv_len (stale tokens, padding, NaN) never reaches the
    output, as the TPU kernel's property test holds for it."""
    ((_, q), (_, k), (_, v)), _ = _dec_inputs(2, 4, 2, 256, 32, "float32", 5)
    kv_len = torch.tensor([37, 128], dtype=torch.int32)
    clean = ref.gqa_decode(q, k, v, kv_len)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(kv_len.tolist()):
        k2[b, :, n:] = garbage
        v2[b, :, n:] = -garbage
    dirty = ref.gqa_decode(q, k2, v2, kv_len)
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, rtol=1e-6, atol=0)


def test_gqa_decode_kv_len_past_smax_attends_the_whole_cache():
    """An idle engine slot's kv_len grows past Smax: the plain version, the
    jnp oracle and the Pallas kernel all attend the whole cache then."""
    (qp, kp, vp), _ = _dec_inputs(3, 4, 2, 64, 32, "float32", 9)
    (qj, qt), (kj, kt), (vj, vt) = qp, kp, vp
    over = np.array([64 + 25, 64, 200], np.int32)
    got = ref.gqa_decode(qt, kt, vt, torch.from_numpy(over))
    full = ref.gqa_decode(qt, kt, vt, torch.full((3,), 64, dtype=torch.int32))
    torch.testing.assert_close(got, full, rtol=0, atol=0)
    _close(got, rref.gqa_decode(qj, kj, vj, jnp.asarray(over)), 2e-5)
    _close(got, rdec.gqa_decode_attention(qj, kj, vj, jnp.asarray(over),
                                          block_k=32, interpret=True), 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gqa_decode_kv_len_zero_gives_zeros(dtype):
    """kv_len == 0 gives zeros, as the Pallas kernel's clamped normaliser
    does, while the other rows are unchanged."""
    ((qj, qt), (kj, kt), (vj, vt)), _ = _dec_inputs(3, 8, 2, 128, 64, dtype,
                                                    11)
    lens = np.array([0, 50, 0], np.int32)
    got = ref.gqa_decode(qt, kt, vt, torch.from_numpy(lens))
    assert not got[0].any() and not got[2].any()
    pallas = rdec.gqa_decode_attention(qj, kj, vj, jnp.asarray(lens),
                                       block_k=64, interpret=True)
    _close(got, pallas, DTYPES[dtype][2])
    assert np.isnan(np.asarray(rref.gqa_decode(qj, kj, vj,
                                               jnp.asarray(lens)))[0]).all()


def test_gqa_decode_reads_the_engine_layout_in_place():
    """One layer of the engine's (B, Smax, Hkv, D) cache, permuted to
    (B, Hkv, Smax, D) without a copy, gives the contiguous answer."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 32))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64, 2, 32))
                         .astype(np.float32))
    lens = torch.tensor([5, 64], dtype=torch.int32)
    kv, vv = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    assert not kv.is_contiguous()
    torch.testing.assert_close(
        ops.gqa_decode_attention(q, kv, vv, lens),
        ref.gqa_decode(q, kv.contiguous(), vv.contiguous(), lens),
        rtol=0, atol=0)



# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------
PAGED_CASES = [
    # (B, Hq, Hkv, n_blocks, block_size, max_blocks, D), as
    # tests/test_kernels.py, and the serving heads at a small pool
    (1, 8, 8, 16, 16, 4, 64),
    (2, 8, 2, 24, 16, 4, 64),
    (3, 4, 1, 12, 8, 6, 32),
    (2, 16, 8, 10, 16, 3, 128),
]


def _paged_inputs(B, Hq, Hkv, nb, bs, mb, D, dtype, seed, store_layout):
    """q, pools (as jnp in the Pallas layout (n_blocks, Hkv, bs, D) and as
    torch, either that layout or the serving store's (n_blocks, bs, Hkv, D)
    permuted to it without a copy), a block table with pad entries past
    kv_len and a negative id, and kv_len with a 0 and a mid-block end."""
    rng = np.random.default_rng(seed)
    q = _both(rng.standard_normal((B, Hq, D)).astype(np.float32), dtype)
    pools = []
    for _ in range(2):
        x = rng.standard_normal((nb, Hkv, bs, D)).astype(np.float32)
        xj, xt = _both(x, dtype)
        if store_layout:
            xt = xt.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        pools.append((xj, xt))
    bt = np.stack([rng.choice(nb, mb, replace=False) for _ in range(B)])
    lens = rng.integers(1, mb * bs + 1, B).astype(np.int32)
    lens[0] = 0 if B > 1 else lens[0]
    lens[-1] = bs + bs // 2                   # ends mid-block
    for b in range(B):                        # pads past the live blocks
        live = -(-int(lens[b]) // bs)
        bt[b, live:] = -1 if b % 2 else 0
    return q, pools, bt.astype(np.int32), lens


@pytest.mark.parametrize("B,Hq,Hkv,nb,bs,mb,D", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("store_layout", [False, True])
def test_paged_decode_matches_reference(B, Hq, Hkv, nb, bs, mb, D, dtype,
                                        store_layout):
    (qj, qt), ((kj, kt), (vj, vt)), bt, lens = _paged_inputs(
        B, Hq, Hkv, nb, bs, mb, D, dtype, B * 100 + Hq, store_layout)
    assert kt.is_contiguous() != store_layout or Hkv == 1  # size-1 axis
    tol = DTYPES[dtype][2]
    before = paged_attention.LAUNCHES
    got = ops.paged_gqa_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                         torch.from_numpy(lens))
    assert paged_attention.LAUNCHES == before
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = rpaged.paged_gqa_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                             jnp.asarray(lens),
                                             interpret=True)
    _close(got, want, tol)
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


def test_paged_decode_ignores_pad_entries_and_unreferenced_blocks():
    """Entries past kv_len (any id, negative ones) and whatever the blocks
    they name hold (NaN) leave the output bit for bit unchanged, and a
    paged row equals the contiguous decode on the gathered cache."""
    (_, q), ((_, kp), (_, vp)), bt, lens = _paged_inputs(
        2, 4, 2, 12, 8, 4, 32, "float32", 21, True)
    lens = torch.tensor([10, 20], dtype=torch.int32)
    bt = torch.tensor([[3, 5, 6, 7], [1, 2, 9, 0]], dtype=torch.int32)
    clean = ref.paged_gqa_decode(q, kp, vp, bt, lens)
    bt2 = bt.clone()
    bt2[0, 2:] = torch.tensor([-1, 11])
    bt2[1, 3] = -5
    k2, v2 = kp.clone(), vp.clone()
    for blk in (6, 7, 11, 0):                 # referenced past kv_len only
        k2[blk], v2[blk] = float("nan"), float("nan")
    torch.testing.assert_close(ref.paged_gqa_decode(q, k2, v2, bt2, lens),
                               clean, rtol=0, atol=0)
    gathered = [p[bt.long()].permute(0, 2, 1, 3, 4).reshape(2, 2, 32, 32)
                for p in (kp, vp)]
    torch.testing.assert_close(ref.gqa_decode(q, *gathered, lens), clean,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# prefix-extend attention
# ---------------------------------------------------------------------------
EXT_CASES = [
    # (B, Hq, Hkv, S_pre, Sq, D, prefix_len): prefix_len None is the
    # exact-length mode; otherwise the prefix buffer is padded past it
    (1, 4, 4, 16, 8, 32, None),
    (2, 8, 2, 24, 17, 64, None),
    (1, 16, 8, 64, 32, 128, 40),
    (2, 4, 1, 48, 5, 32, 16),
    (1, 4, 2, 32, 32, 32, 0),
]


def _ext_inputs(B, Hq, Hkv, S_pre, Sq, D, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, Sq, D), (B, Hkv, S_pre, D), (B, Hkv, S_pre, D),
              (B, Hkv, Sq, D), (B, Hkv, Sq, D))
    return [_both(rng.standard_normal(s).astype(np.float32), dtype)
            for s in shapes]


def _xla_extend(q, kp, vp, k, v, prefix_len):
    """The reference's attention_prefill_extend attention, (B, H, S, D) in
    and out: ``_xla_attention`` with q_offset (exact-length mode) or with
    the bucketed mask."""
    S_pre, Sq = kp.shape[2], q.shape[2]
    sw = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    kf = jnp.concatenate([sw(kp), sw(k)], axis=1)
    vf = jnp.concatenate([sw(vp), sw(v)], axis=1)
    if prefix_len is None:
        out = RL._xla_attention(sw(q), kf, vf, causal=True, q_offset=S_pre)
    else:
        col = jnp.arange(S_pre + Sq)[None, :]
        row = jnp.arange(Sq)[:, None]
        mask = jnp.where(col < S_pre, col < prefix_len, (col - S_pre) <= row)
        out = RL._xla_attention(sw(q), kf, vf, causal=False, mask=mask)
    return sw(out)


@pytest.mark.parametrize("B,Hq,Hkv,S_pre,Sq,D,plen", EXT_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mha_prefill_extend_matches_reference(B, Hq, Hkv, S_pre, Sq, D, plen,
                                              dtype):
    ins = _ext_inputs(B, Hq, Hkv, S_pre, Sq, D, dtype, S_pre + Sq + Hq)
    js, ts = [j for j, _ in ins], [t for _, t in ins]
    before = flash_attention.LAUNCHES
    got = ops.flash_attention_extend(*ts, prefix_len=plen)
    assert flash_attention.LAUNCHES == before
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    _close(got, _xla_extend(*js, plen), DTYPES[dtype][2])


def test_mha_prefill_extend_equals_full_attention_and_skips_padding():
    """Exact-length mode over a prefix equals causal attention over the
    whole prompt's last rows; in the bucketed mode the prefix rows past
    prefix_len (block-0 padding, NaN) change nothing."""
    rng = np.random.default_rng(17)
    S_pre, Sq = 24, 9
    q, k, v = (torch.from_numpy(rng.standard_normal((1, h, S_pre + Sq, 32))
                                .astype(np.float32)) for h in (4, 2, 2))
    full = ref.mha_prefill(q, k, v, causal=True)[:, :, S_pre:]
    got = ref.mha_prefill_extend(q[:, :, S_pre:], k[:, :, :S_pre],
                                 v[:, :, :S_pre], k[:, :, S_pre:],
                                 v[:, :, S_pre:])
    torch.testing.assert_close(got, full, rtol=2e-5, atol=2e-5)
    pad = lambda t: torch.cat([t[:, :, :S_pre], torch.full(  # noqa: E731
        (1, 2, 16, 32), float("nan"))], dim=2)
    padded = ref.mha_prefill_extend(q[:, :, S_pre:], pad(k), pad(v),
                                    k[:, :, S_pre:], v[:, :, S_pre:],
                                    prefix_len=S_pre)
    torch.testing.assert_close(padded, got, rtol=0, atol=0)


def test_new_kernels_dispatch_by_device_without_launching_on_the_cpu():
    before = (paged_attention.LAUNCHES, flash_attention.LAUNCHES,
              decode_attention.LAUNCHES)
    q = torch.rand(1, 4, 16)
    pool = torch.rand(3, 2, 8, 16)
    bt = torch.tensor([[2, 0]], dtype=torch.int32)
    lens = torch.tensor([9], dtype=torch.int32)
    assert ops.paged_gqa_decode_attention(q, pool, pool, bt,
                                          lens).shape == q.shape
    qs, kp = torch.rand(1, 4, 5, 16), torch.rand(1, 2, 7, 16)
    ks = torch.rand(1, 2, 5, 16)
    assert ops.flash_attention_extend(qs, kp, kp, ks, ks,
                                      prefix_len=3).shape == qs.shape
    assert (paged_attention.LAUNCHES, flash_attention.LAUNCHES,
            decode_attention.LAUNCHES) == before
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="no paged_gqa_decode_attention"):
        ops.paged_gqa_decode_attention(*meta(q, pool, pool, bt, lens))
    with pytest.raises(ValueError, match="no flash_attention_extend"):
        ops.flash_attention_extend(*meta(qs, kp, kp, ks, ks))
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention.paged_gqa_decode_attention_cuda(q, pool, pool, bt,
                                                        lens)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_extend_cuda(qs, kp, kp, ks, ks)


# ---------------------------------------------------------------------------
# the arithmetic of the Hopper kernels, rehearsed in plain torch
# ---------------------------------------------------------------------------
# The CUDA kernels run only on the card, where chip_smoke.py holds them
# against ``kernels.ref``. What they compute differs from the plain versions
# in order and rounding, so the same arithmetic is rehearsed here, in short
# copies that can drift from the .cu files, and held against
# ``kernels.ref``: the bf16 flash kernel's 64-key tiles (scores in f32,
# scaled after the product, a base-2 online softmax, P rounded to bf16
# before P.V, rows past a limit zero, tiles dealt to two warpgroups and
# merged) and the decode kernel's split over positions (per split, warps of
# 32 positions each with an online softmax, merged in warp order, then the
# splits in split order).

LOG2E = 1.4426950408889634


def _tiles_of(kk, vv, limit, tile=64):
    """(k0, K tile, V tile) of rows [0, limit), each zero-padded to ``tile``
    rows as the kernel's zero-filling copies leave them."""
    out = []
    for k0 in range(0, limit, tile):
        rows = min(tile, limit - k0)
        pad = lambda t: torch.cat([t[:, :, k0:k0 + rows], t.new_zeros(  # noqa
            t.shape[:2] + (tile - rows, t.shape[3]))], dim=2)
        out.append((k0, pad(kk), pad(vv)))
    return out


def _tiled_flash_bf16(q, k, v, k_pre=None, v_pre=None, prefix_len=0,
                      causal=True, groups=1):
    """A rehearsal of the bf16 tensor-core flash kernel's arithmetic over
    64-key tiles; (B, Hq, S, D) bf16 q, (B, Hkv, S, D) k, v and a prefix
    read up to prefix_len. The running max is of scores scaled to base 2; a
    row that has met no valid key subtracts 0 instead of -inf. With
    ``groups`` warpgroups the tiles are dealt in turns, each warpgroup keeps
    its own state, and the first merges the others' in order."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    rep = lambda t: t.float().repeat_interleave(G, dim=1)  # noqa: E731
    qf = q.float()
    ninf = float("-inf")
    rows = torch.arange(S)[:, None]
    scale = D ** -0.5 * LOG2E
    steps = [(t, False, prefix_len)
             for t in _tiles_of(k_pre, v_pre, prefix_len)
             ] if prefix_len else []
    steps += [(t, causal, S) for t in _tiles_of(k, v, S)]
    states = []
    for g in range(groups):
        m = torch.full((B, Hq, S), ninf)
        l, acc = torch.zeros((B, Hq, S)), torch.zeros((B, Hq, S, D))
        for (k0, kt, vt), diag, lim in steps[g::groups]:
            s = torch.einsum("bhqd,bhkd->bhqk", qf, rep(kt))
            col = k0 + torch.arange(kt.shape[2])[None, :]
            ok = (col < lim) & (~torch.tensor(diag) | (col <= rows))
            s = torch.where(ok, s, ninf)
            mn = torch.maximum(m, s.amax(-1) * scale)
            b = torch.where(mn == ninf, 0.0, mn)
            alpha = torch.exp2(m - b)
            p = torch.exp2(s * scale - b[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), rep(vt))
            m = mn
        states.append((m, l, acc))
    m, l, acc = states[0]
    for mb, lb, accb in states[1:]:
        mn = torch.maximum(m, mb)
        b = torch.where(mn == ninf, 0.0, mn)
        ca, cb = torch.exp2(m - b), torch.exp2(mb - b)
        l = l * ca + lb * cb
        acc = acc * ca[..., None] + accb * cb[..., None]
        m = mn
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("Hq,Hkv,D", [(16, 8, 128), (32, 32, 80),
                                      (8, 1, 64)])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_bf16_flash_arithmetic_matches_plain(Hq, Hkv, D, S, causal):
    """64-key tiles, scores scaled after the product, P rounded to bf16:
    within the 2e-2 bf16 tolerance of ``ref.mha_prefill``, ragged S
    included."""
    rng = np.random.default_rng(S * 31 + D)
    q, k, v = _bf16(rng, 1, Hq, S, D), _bf16(rng, 1, Hkv, S, D), \
        _bf16(rng, 1, Hkv, S, D)
    got = _tiled_flash_bf16(q, k, v, causal=causal)
    _close(got, ref.mha_prefill(q, k, v, causal=causal).float().numpy(),
           2e-2)


@pytest.mark.parametrize("S_pre,Sq,plen", [(16, 8, None), (200, 1, None),
                                           (64, 17, 40), (32, 33, 0),
                                           (160, 64, 130), (192, 70, 128)])
def test_tiled_bf16_flash_extend_arithmetic_matches_plain(S_pre, Sq, plen):
    """The extend variant's tiles: the prefix's up to prefix_len, then the
    suffix's causally; NaN past prefix_len is never read."""
    rng = np.random.default_rng(S_pre + Sq)
    Hq, Hkv, D = 16, 8, 128
    q = _bf16(rng, 1, Hq, Sq, D)
    kp, vp = _bf16(rng, 1, Hkv, S_pre, D), _bf16(rng, 1, Hkv, S_pre, D)
    k, v = _bf16(rng, 1, Hkv, Sq, D), _bf16(rng, 1, Hkv, Sq, D)
    n = S_pre if plen is None else plen
    kp[:, :, n:], vp[:, :, n:] = float("nan"), float("nan")
    got = _tiled_flash_bf16(q, k, v, kp, vp, n)
    assert torch.isfinite(got).all()
    want = ref.mha_prefill_extend(q, kp, vp, k, v, plen)
    _close(got, want.float().numpy(), 2e-2)


@pytest.mark.parametrize("S,causal,S_pre,plen", [
    (64, True, 0, 0), (128, True, 0, 0), (130, False, 0, 0),
    (257, True, 0, 0), (128, True, 1088, 224), (64, True, 200, 130),
    (1, True, 192, 128)])
def test_two_warpgroup_flash_arithmetic_matches_plain(S, causal, S_pre,
                                                      plen):
    """Tiles dealt to two warpgroups in turns and merged in order (an odd
    tile count leaves the second an empty tile): within the 2e-2 bf16
    tolerance of the plain versions."""
    rng = np.random.default_rng(S + S_pre)
    Hq, Hkv, D = 16, 8, 128
    q, k, v = (_bf16(rng, 1, h, S, D) for h in (Hq, Hkv, Hkv))
    if S_pre:
        kp, vp = _bf16(rng, 1, Hkv, S_pre, D), _bf16(rng, 1, Hkv, S_pre, D)
        got = _tiled_flash_bf16(q, k, v, kp, vp, plen, groups=2)
        want = ref.mha_prefill_extend(q, kp, vp, k, v, plen)
    else:
        got = _tiled_flash_bf16(q, k, v, causal=causal, groups=2)
        want = ref.mha_prefill(q, k, v, causal=causal)
    _close(got, want.float().numpy(), 2e-2)


def test_flash_groups_from_the_shapes():
    """Two warpgroups where the longest row has a second key tile; one
    otherwise."""
    g = flash_attention.flash_groups
    assert g(1, 0) == g(64, 0) == 1           # one key tile
    assert g(65, 0) == g(128, 0) == g(512, 0) == g(1088, 0) == 2
    assert g(128, 224) == 2                   # the session median extend
    assert g(1, 64) == g(64, 960) == 2        # prefix tiles, then one more


def _split_decode(q, k, v, kv_len, span, paged=None, read=None):
    """A rehearsal of the split decode kernel's arithmetic in f32: (B, Hq, D)
    q over (B, Hkv, Smax, D) caches, positions split in spans of ``span``.
    With ``paged=(block_table, bs)``, k and v are (n_blocks, Hkv, bs, D)
    pools and Smax is max_blocks * bs: a block reads the table entries of its
    span once, clamped at 0 (each one added to ``read`` as (b, entry)), and
    finds position p's row in block tbl[p // bs - first] at p % bs, as the
    kernel's PagedRows policy does. The kernel itself is held against
    ``ref`` on the card (chip_smoke)."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    Smax = k.shape[2] if paged is None else paged[0].shape[1] * paged[1]
    G = Hq // Hkv
    splits = -(-Smax // span)
    ninf = float("-inf")
    out = torch.zeros((B, Hq, D))

    def merge(states):       # in the given order
        mm = torch.stack([s[0] for s in states]).amax(0)
        ll, aa = torch.zeros(G), torch.zeros((G, D))
        for m, l, a in states:
            c = torch.where(m == ninf, 0.0, torch.exp(m - mm))
            ll = ll + torch.where(m == ninf, 0.0, l * c)
            aa = aa + torch.where((m == ninf)[:, None], 0.0, a * c[:, None])
        return mm, ll, aa

    def span_rows(b, hk, lo, hi):
        """K and V rows of positions [lo, hi) of (b, kv head hk)."""
        if paged is None:
            return k[b, hk, lo:hi], v[b, hk, lo:hi]
        bt, bs = paged
        first = lo // bs
        tbl = [max(int(bt[b, e]), 0) for e in range(first, (hi - 1) // bs + 1)]
        if read is not None:
            read.update((b, e) for e in range(first, first + len(tbl)))
        at = [(tbl[p // bs - first], p % bs) for p in range(lo, hi)]
        return (torch.stack([k[blk, hk, o] for blk, o in at]),
                torch.stack([v[blk, hk, o] for blk, o in at]))

    for b in range(B):
        n = min(max(int(kv_len[b]), 0), Smax)
        for hk in range(Hkv):
            qg = q[b, hk * G:(hk + 1) * G].float()
            parts = []
            for sp in range(splits):
                lo, hi = sp * span, min(sp * span + span, n)
                empty = (torch.full((G,), ninf), torch.zeros(G),
                         torch.zeros((G, D)))
                if lo >= hi:
                    parts.append(empty)
                    continue
                ks, vs = span_rows(b, hk, lo, hi)
                warps = []
                for w in range(4):
                    m, l, a = empty
                    for s0 in range(lo + 32 * w, hi, 128):
                        kc = ks[s0 - lo:min(s0 + 32, hi) - lo].float()
                        vc = vs[s0 - lo:min(s0 + 32, hi) - lo].float()
                        sc = (qg @ kc.T) * D ** -0.5
                        mn = torch.maximum(m, sc.amax(-1))
                        alpha = torch.where(mn == ninf, 1.0,
                                            torch.exp(m - mn))
                        p = torch.exp(sc - mn[:, None])
                        l = l * alpha + p.sum(-1)
                        a = a * alpha[:, None] + p @ vc
                        m = mn
                    warps.append((m, l, a))
                parts.append(merge(warps))
            _, ll, aa = merge(parts)
            out[b, hk * G:(hk + 1) * G] = aa / ll.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("splits", range(1, 10))
def test_split_decode_arithmetic_matches_plain(splits):
    """1-9 spans of 128 positions, merged in split order: within 1e-6 of
    ``ref.gqa_decode`` in f32, with empty spans, kv_len 0 and past Smax."""
    Smax = 128 * splits - 5
    B, Hq, Hkv, D = 4, 8, 2, 32
    span, got_splits = decode_attention.decode_split(B, Hkv, Smax, 132)
    assert (span, got_splits) == (128, splits)
    rng = np.random.default_rng(splits)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, D), (B, Hkv, Smax, D), (B, Hkv, Smax, D)))
    lens = torch.tensor([0, Smax + 40, 1 + (Smax - 1) // 2, 128 if
                         splits > 1 else 33], dtype=torch.int32)
    got = _split_decode(q, k, v, lens, span)
    torch.testing.assert_close(got, ref.gqa_decode(q, k, v, lens),
                               rtol=1e-6, atol=1e-6)
    assert not got[0].any()


def test_split_decode_with_spans_of_several_steps():
    """A large batch on few SMs gets spans of several 128-position steps;
    each warp then walks its positions in steps of 128."""
    span, splits = decode_attention.decode_split(2, 2, 1088, n_sm=2)
    assert (span, splits) == (640, 2)
    rng = np.random.default_rng(40)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 16), (2, 2, 1088, 16), (2, 2, 1088, 16)))
    lens = torch.tensor([1000, 641], dtype=torch.int32)
    torch.testing.assert_close(_split_decode(q, k, v, lens, span),
                               ref.gqa_decode(q, k, v, lens),
                               rtol=1e-6, atol=1e-6)


# PAGED_CASES, and pools whose max_blocks * bs spans 2 and 3 splits of 128
# positions, one of them with blocks of 12 (a span that is not a multiple
# of the block size)
PAGED_SPLIT_CASES = PAGED_CASES + [(3, 4, 1, 20, 16, 16, 32),
                                   (2, 8, 2, 40, 12, 30, 32)]


@pytest.mark.parametrize("B,Hq,Hkv,nb,bs,mb,D", PAGED_SPLIT_CASES)
@pytest.mark.parametrize("store_layout", [False, True])
def test_paged_split_decode_arithmetic_matches_plain_and_pallas(
        B, Hq, Hkv, nb, bs, mb, D, store_layout):
    """The split kernel's plan with paged row addresses: within 1e-6 of
    ``ref.paged_gqa_decode`` and of the Pallas paged kernel in f32, with pad
    and negative entries, kv_len 0 and a row ending mid-block; no table
    entry past a row's kv_len is read; and bit for bit the contiguous
    rehearsal's result on the gathered cache, whose Smax is
    max_blocks * bs."""
    (qj, qt), ((kj, kt), (vj, vt)), bt, lens = _paged_inputs(
        B, Hq, Hkv, nb, bs, mb, D, "float32", B * 100 + nb, store_layout)
    if B > 1:
        bt[1, 0] = -3                      # a live negative id: block 0
    span, splits = decode_attention.decode_split(B, Hkv, mb * bs, 132)
    assert splits == -(-mb * bs // 128)
    btt, lt = torch.from_numpy(bt), torch.from_numpy(lens)
    read = set()
    got = _split_decode(qt, kt, vt, lt, span, paged=(btt, bs), read=read)
    want = ref.paged_gqa_decode(qt, kt, vt, btt, lt)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    pallas = rpaged.paged_gqa_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                               jnp.asarray(lens),
                                               interpret=True)
    _close(got, pallas, 1e-6)
    assert all(e <= (min(int(lens[b]), mb * bs) - 1) // bs for b, e in read)
    assert not any(b == 0 for b, _ in read) or lens[0] > 0
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()
    gathered = [p[btt.long().clamp(min=0)].permute(0, 2, 1, 3, 4)
                .reshape(B, Hkv, mb * bs, D) for p in (kt, vt)]
    assert decode_attention.decode_split(B, Hkv, mb * bs, 132) == (span,
                                                                   splits)
    contiguous = _split_decode(qt, *gathered, lt, span)
    assert torch.equal(got, contiguous)


@pytest.mark.parametrize("B,Hkv", [(1, 1), (2, 2), (8, 8), (8, 1), (64, 8),
                                   (256, 8)])
@pytest.mark.parametrize("Smax", [1, 64, 127, 128, 512, 520, 1088, 32768])
def test_decode_split_fills_the_card_from_the_shapes(B, Hkv, Smax):
    """Spans are multiples of 128 that cover Smax with no empty tail
    split; the grid holds at least 2 blocks per SM where Smax allows, and
    not many more than 4."""
    n_sm = 132
    span, splits = decode_attention.decode_split(B, Hkv, Smax, n_sm)
    assert span % decode_attention.SPAN_STEP == 0 and span > 0
    assert (splits - 1) * span < Smax <= splits * span
    steps = -(-Smax // 128)
    assert B * Hkv * splits >= min(2 * n_sm, B * Hkv * steps) or splits == 1
    assert splits <= max(1, -(-4 * n_sm // (B * Hkv)))


def test_decode_split_at_the_serving_shapes():
    assert decode_attention.decode_split(8, 8, 512, 132) == (128, 4)
    assert decode_attention.decode_split(8, 8, 1088, 132) == (128, 9)


def test_alignment_check_takes_the_engine_views_and_refuses_the_rest():
    ok = [torch.zeros((2, 512, 8, 128), dtype=torch.bfloat16)
          .permute(0, 2, 1, 3),                      # the engine's cache
          torch.zeros((1, 64, 16, 80), dtype=torch.bfloat16)
          .transpose(1, 2),                          # projections, D 80
          torch.zeros((3, 4, 9, 64), dtype=torch.float32)]
    decode_attention.check_alignment("t", *ok)
    base = torch.zeros(4 * 9 * 64 + 8, dtype=torch.bfloat16)
    odd_stride = torch.zeros((1, 2, 9, 68), dtype=torch.bfloat16)[..., :64]
    offset = base[1:1 + 4 * 9 * 64].view(1, 4, 9, 64)
    narrow = torch.zeros((1, 2, 9, 12), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="strides"):
        decode_attention.check_alignment("t", ok[0], odd_stride)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention.check_alignment("t", offset)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_attention.check_alignment("t", narrow)


def test_paged_alignment_check_takes_the_store_pools_and_refuses_the_rest():
    """The paged wrapper holds its pools to the same 16-byte rule: one
    layer of the serving store's (n_layers, n_blocks, bs, Hkv, D) pool,
    permuted to (n_blocks, Hkv, bs, D) in place, passes; a pool view with
    an odd row stride, one off an aligned address, and a head dim that is
    not a multiple of 8 are refused."""
    from repro_torch.configs import get
    from repro_torch.serving.kvcache import PagedKVStore
    cfg = get("qwen3-1.7b").smoke()
    store = PagedKVStore(cfg, 12, 16, device="cpu")
    for li in range(cfg.n_layers):
        decode_attention.check_alignment(
            "paged", store.k[li].permute(0, 2, 1, 3),
            store.v[li].permute(0, 2, 1, 3))
    odd = torch.zeros((12, 16, 2, 68), dtype=torch.bfloat16)[..., :64]
    raw = torch.zeros(12 * 2 * 16 * 64 + 8, dtype=torch.bfloat16)
    off = raw[1:1 + 12 * 2 * 16 * 64].view(12, 2, 16, 64)
    narrow = torch.zeros((12, 2, 16, 12), dtype=torch.bfloat16)
    for bad, match in ((odd.permute(0, 2, 1, 3), "strides"),
                       (off, "16-byte aligned"), (narrow, "multiple of 8")):
        with pytest.raises(ValueError, match=match):
            decode_attention.check_alignment("paged", bad, bad)
    src = inspect.getsource(paged_attention.paged_gqa_decode_attention_cuda)
    assert "check_alignment(name, k_pool, v_pool)" in src


def test_flash_route_by_dtype():
    assert flash_attention.route(torch.bfloat16) == "wgmma"
    assert flash_attention.route(torch.float32) == "cuda_cores"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.route(torch.float16)


def test_decode_tickets_are_kept_per_stream():
    """Calls on one stream share a zeroed ticket buffer; another stream
    gets its own, so calls on two streams never race on a ticket."""
    dev = torch.device("cpu")
    a = decode_attention._tickets(dev, 11, 16)
    assert a.dtype == torch.int32 and a.numel() >= 16 and not a.any()
    assert decode_attention._tickets(dev, 11, 8) is a
    b = decode_attention._tickets(dev, 12, 16)
    assert b is not a and not b.any()
    big = decode_attention._tickets(dev, 11, 4096)
    assert big.numel() >= 4096 and decode_attention._tickets(dev, 11, 16) \
        is big
    for key in ((dev, 11), (dev, 12)):
        del decode_attention._TICKETS[key]
