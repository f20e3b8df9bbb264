"""Split-sequence decode attention: the plain version of the decode
kernel's partial mode (``ref.gqa_decode_partial``) and the merge of the
blocks' results (``tensor_parallel.merge``), held against the JAX
package's ``repro.kernels.ref.gqa_decode`` over the whole cache.

This is how a rank of the sharded serve step attends: its block of the
positions (``tensor_parallel.seq_range``, contiguous near-equal ranges),
kv_len clamped to the block, then the ranks' (o, lse) merged. The same
numpy inputs, from a seed, are cut into 1, 2 and 3 blocks (even and
uneven), within 2e-5 of the reference in f32 and 2e-2 in bf16. The rows'
lengths take in a row that ends on a block's edge, rows that lie in one
block only, and a row past Smax (it attends the whole cache). Also: kv_len
0 gives o = 0 and lse = -inf in every block and zeros merged (the TPU
kernel's answer; the jnp oracle's is NaN); a one-block merge returns its
input's bits, and rounds to ``ref.gqa_decode``'s; the wrapper dispatches
by device and the kernel's wrapper takes CUDA tensors only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import decode_attention, ops, ref
from repro_torch.models import tensor_parallel as TP

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: (B, Hq, Hkv, Smax, D)
SHAPE = (6, 8, 2, 130, 32)


def _inputs(dtype: str, lens, seed=27):
    """q (B, Hq, D), k and v (B, Hkv, Smax, D) as torch tensors of
    ``dtype`` and jnp arrays of the same values, and kv_len (B,)."""
    B, Hq, Hkv, Smax, D = SHAPE
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, D), (B, Hkv, Smax, D), (B, Hkv, Smax, D))]
    tdt = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, JNP[dtype]) for a in arrs],
            np.asarray(lens, np.int32))


def _blocks(q, k, v, kv_len: np.ndarray, n: int):
    """Each of n ranks' partial result over its block of the positions:
    (o (n, B, Hq, D), lse (n, B, Hq))."""
    Smax = k.shape[2]
    os_, lses = [], []
    for r in range(n):
        lo, hi = TP.seq_range(Smax, TP.Region(None, n, r))
        local = torch.from_numpy(np.clip(kv_len - lo, 0, hi - lo))
        o, lse = ops.gqa_decode_partial(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                        local)
        assert o.dtype == lse.dtype == torch.float32
        os_.append(o)
        lses.append(lse)
    return torch.stack(os_), torch.stack(lses)


def _merged_vs_reference(dtype: str, n: int):
    # 130 positions: blocks of 130 / 65 + 65 / 43 + 43 + 44. Row 1 ends on
    # the 2-block edge, rows 2 and 4 on the 3-block edges; rows 2 and 3 lie
    # in the first block only; row 5 is past Smax
    lens = (130, 65, 43, 20, 86, 500)
    (q, k, v), (qj, kj, vj), kv_len = _inputs(dtype, lens)
    if n == 3:
        assert [TP.seq_range(130, TP.Region(None, 3, r)) for r in
                range(3)] == [(0, 43), (43, 86), (86, 130)]
    o, lse = _blocks(q, k, v, kv_len, n)
    got = TP.merge(o, lse)
    want = np.asarray(rref.gqa_decode(qj, kj, vj, jnp.asarray(kv_len)),
                      np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the whole-cache partial's lse is the log-sum-exp over every block
    _, whole = _blocks(q, k, v, kv_len, 1)
    np.testing.assert_allclose(torch.logsumexp(lse, 0).numpy(),
                               whole[0].numpy(), atol=1e-5, rtol=1e-5)


def _kv_len_zero():
    (q, k, v), _, kv_len = _inputs("float32", (0, 0, 7, 0, 130, 0))
    for n in (1, 2, 3):
        o, lse = _blocks(q, k, v, kv_len, n)
        empty = torch.from_numpy(kv_len == 0)
        assert bool((o[:, empty] == 0).all())
        assert bool((lse[:, empty] == float("-inf")).all())
        got = TP.merge(o, lse)
        assert bool((got[empty] == 0).all())
        assert bool(torch.isfinite(got).all())


def _past_smax_attends_the_whole_cache():
    (q, k, v), _, _ = _inputs("float32", ())
    over = np.asarray((131, 200, 10_000, 130, 131, 999), np.int32)
    for n in (1, 2, 3):
        got = TP.merge(*_blocks(q, k, v, over, n))
        full = TP.merge(*_blocks(q, k, v, np.full(6, 130, np.int32), n))
        assert torch.equal(got, full)


def _one_block_keeps_its_bits(dtype: str):
    (q, k, v), _, kv_len = _inputs(dtype, (130, 65, 0, 1, 129, 300))
    o, lse = _blocks(q, k, v, kv_len, 1)
    merged = TP.merge(o, lse)
    assert torch.equal(merged, o[0])
    assert torch.equal(merged.to(q.dtype),
                       ref.gqa_decode(q, k, v, torch.from_numpy(kv_len)))


def _dispatch():
    (q, k, v), _, kv_len = _inputs("float32", (130, 1, 2, 3, 4, 5))
    lens = torch.from_numpy(kv_len)
    got = ops.gqa_decode_partial(q, k, v, lens)
    want = ref.gqa_decode_partial(q, k, v, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_attention.gqa_decode_partial_cuda(q, k, v, lens)
    with pytest.raises(ValueError, match="no gqa_decode_partial"):
        ops.gqa_decode_partial(*(t.to("meta") for t in (q, k, v, lens)))


CASES = {
    **{f"{dt}-{n}-blocks": (lambda dt=dt, n=n: _merged_vs_reference(dt, n))
       for dt in TOL for n in (1, 2, 3)},
    "kv_len-0-gives-zeros": _kv_len_zero,
    "past-smax-attends-the-whole-cache": _past_smax_attends_the_whole_cache,
    **{f"{dt}-one-block-keeps-its-bits":
       (lambda dt=dt: _one_block_keeps_its_bits(dt)) for dt in TOL},
    "dispatch-by-device": _dispatch,
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_sequence_decode(case):
    CASES[case]()
