"""The attention kernels' plain versions, held against the reference.

``repro_torch.kernels.ref.mha_prefill`` and ``ref.gqa_decode`` are what a
CPU tensor runs and what ``chip_smoke.py`` holds the CUDA kernels against on
the card. Here the same numpy inputs go through them, through the JAX
package's jnp oracles, and through its Pallas kernels in interpret mode, on
the shapes of ``tests/test_kernels.py``; tolerance 2e-5 in f32 and 2e-2 in
bf16, as there. The decode cases add what the engine relies on: garbage past
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
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref

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

