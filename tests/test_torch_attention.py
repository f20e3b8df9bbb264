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
