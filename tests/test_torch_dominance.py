"""The dominance-matrix kernel's grid and store plan, rehearsed on the CPU.

The CUDA kernel (``csrc/dominance.cu``) runs only on the card, where
``chip_smoke.py`` holds it against ``kernels.ref``. What surrounds its
arithmetic is plain integer bookkeeping, rehearsed here in numpy: the grid
that ``dominance.dominance_grid`` picks, which thread of which block writes
which (i, j), and at which width (16, 8, 4 or 1 bytes: the widest that the
address and the ragged edge allow). Every entry of the P x P matrix must be
written exactly once, no store wider than a byte may be misaligned, and the
bytes the plan writes must be the reference's matrix: the plain version's
and the Pallas kernel's in interpret mode. The kernel's arithmetic on
finite objectives (one subtraction per objective in place of two
comparisons) is rehearsed here too, on the values where it could go wrong.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.dominance as ref_dom
from repro_torch.kernels import dominance, ref

N_SM = 132      # an H100's streaming multiprocessors
COLS = 16       # consecutive columns per thread


def _run_stores(a, n):
    """The stores of the runs that start at flat byte offsets ``a`` with
    ``n`` valid bytes each (1..16), as the kernel's ``store_run`` makes
    them: (run, first byte in the run, width) triples."""
    run = np.arange(len(a))
    out = []
    full = (n == COLS) & (a % 16 == 0)
    out.append((run[full], np.zeros(full.sum(), np.int64), 16))
    rest = ~full
    a8 = rest & (a % 8 == 0)
    a4 = rest & ~a8 & (a % 4 == 0)
    done = np.where(a8, n & ~7, np.where(a4, n & ~3, 0))
    for width, sel in ((8, a8), (4, a4)):
        for k in range(COLS // width):
            hit = sel & (width * k + width <= n)
            out.append((run[hit], np.full(hit.sum(), width * k), width))
    for c in range(COLS):
        hit = rest & (c >= done) & (c < n)
        out.append((run[hit], np.full(hit.sum(), c), 1))
    return out


def _rehearse(F: np.ndarray, n_sm: int = N_SM):
    """Run the matrix kernel's plan over F (P, M): every block of the grid,
    every warp's rows, every lane's 16 columns, every store. Returns the
    matrix the stores write (255 where none wrote), how often each entry was
    written, and the widths used."""
    P = F.shape[0]
    strips, splits, rows = dominance.dominance_grid(P, n_sm)
    D = np.full(P * P, 255, np.uint8)
    hits = np.zeros(P * P, np.int32)
    widths = set()
    lanes = np.arange(32)
    for strip in range(strips):
        j0 = strip * dominance.STRIP + lanes * COLS
        n = np.minimum(COLS, P - j0)
        live = n > 0                                   # else the lane leaves
        for split in range(splits):
            i_begin = split * rows
            i_end = min(P, i_begin + rows)
            # warp w takes rows i_begin + w, + 8, ...: together, all of them
            ii = np.concatenate([np.arange(i_begin + w, i_end,
                                           dominance.ROW_WARPS)
                                 for w in range(dominance.ROW_WARPS)])
            I, L = np.meshgrid(ii, lanes[live], indexing="ij")
            I, L = I.ravel(), L.ravel()
            a = I.astype(np.int64) * P + j0[L]        # D's base: 16-aligned
            block = []
            for run, first, width in _run_stores(a, n[L]):
                if not len(run):
                    continue
                widths.add(width)
                start = a[run] + first
                if width > 1:
                    assert not (start % width).any(), (P, width)
                # a store stays inside its own row's valid columns
                assert (start >= I[run] * P).all()
                assert (start + width <= I[run] * P + P).all()
                for t in range(width):
                    i, j = I[run], j0[L[run]] + first + t
                    fi, fj = F[i], F[j]
                    lt = (fi < fj).any(-1)
                    D[start + t] = lt & (fi <= fj).all(-1)
                    block.append(start + t)
            idx = np.sort(np.concatenate(block))
            assert (np.diff(idx) > 0).all(), "a block writes a byte twice"
            hits[idx] += 1
    return D.reshape(P, P), hits.reshape(P, P), widths


def _objectives(P, M, seed):
    """Quantised objectives (ties), a duplicated row and a NaN row."""
    rng = np.random.default_rng(seed)
    F = (np.round(rng.random((P, M)) * 8) / 8).astype(np.float32)
    if P > 3:
        F[P // 2] = F[0]
        F[P - 1, M - 1] = np.nan
    return F


@pytest.mark.parametrize("P", [1, 7, 15, 16, 17, 100, 130, 200, 1000, 4096,
                               4099, 4104])
def test_dominance_store_plan_writes_each_entry_once(P):
    F = _objectives(P, 3, P)
    D, hits, widths = _rehearse(F)
    assert (hits == 1).all(), (int((hits == 0).sum()), int((hits > 1).sum()))
    want = ref.dominance_matrix(torch.from_numpy(F)).numpy()
    np.testing.assert_array_equal(D, want)
    pallas = np.asarray(ref_dom.dominance_matrix_pallas(jnp.asarray(F),
                                                        interpret=True), bool)
    np.testing.assert_array_equal(D, pallas)
    # the widest store the alignment of a row's start allows
    if P % 16 == 0:
        assert widths == {16}
    elif P % 8 == 0 and P > 16:
        assert 16 in widths and 8 in widths and 4 not in widths
    elif P % 4 == 0 and P > 16:
        assert 4 in widths
    elif P > 16:
        assert {16, 8, 4, 1} <= widths


@pytest.mark.parametrize("P", [1, 7, 16, 200, 1000, 4096, 4104, 20000])
def test_dominance_grid_covers_the_rows_with_long_runs(P):
    """About two blocks per SM where P allows, whole row runs of a multiple
    of the block's warps, and no empty split."""
    strips, splits, rows = dominance.dominance_grid(P, N_SM)
    assert strips == -(-P // dominance.STRIP)
    assert rows % dominance.ROW_WARPS == 0 and rows > 0
    assert (splits - 1) * rows < P <= splits * rows
    assert strips * splits <= 2 * N_SM + strips
    assert strips * splits >= min(3 * N_SM // 2, strips * -(-P // 8))


def test_dominance_grid_at_the_main_path_shapes():
    assert dominance.dominance_grid(4096, 132) == (8, 32, 128)
    assert dominance.dominance_grid(200, 132) == (1, 25, 8)


def _fast_path(fi: np.ndarray, fj: np.ndarray) -> np.ndarray:
    """The kernel's path for finite objectives with -0 made +0: the OR x of
    the bit patterns of the f32 differences fj - fi, read as an int32, is
    positive iff i dominates j (no sign bit: fi <= fj everywhere; not all
    zero: fi < fj somewhere); x is never INT_MIN, so the kernel reads the
    answer from the sign bit of -x (as uint32, wrapping)."""
    with np.errstate(over="ignore"):
        d = (fj - fi).astype(np.float32).view(np.int32)
    x = np.bitwise_or.reduce(d, axis=-1)
    assert not (x == np.iinfo(np.int32).min).any()
    y = (np.uint32(0) - x.astype(np.uint32)).astype(np.uint32)
    return (y >> np.uint32(31)).astype(bool)


def _prmt(a: int, b: int, sel: int) -> int:
    """PTX ``prmt.b32`` (default mode): result byte i is byte (s & 7) of
    the 8 bytes {b, a}, or that byte's sign in all eight bits when s & 8,
    for selector nibble s = (sel >> 4 i) & 15."""
    src = (b << 32 | a).to_bytes(8, "little")
    out = 0
    for i in range(4):
        s = (sel >> 4 * i) & 15
        byte = src[s & 7]
        if s & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << 8 * i
    return out


def test_dominance_sign_packing():
    """``pack_signs``: three byte permutes and a mask put y[q]'s sign bit
    in byte q as 0 or 1."""
    rng = np.random.default_rng(3)
    for _ in range(500):
        y = [int(v) for v in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
        lo = _prmt(y[0], y[1], 0x00FB)
        hi = _prmt(y[2], y[3], 0x00FB)
        w = _prmt(lo, hi, 0x5410) & 0x01010101
        assert w == sum((v >> 31) << 8 * q for q, v in enumerate(y))


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_dominance_finite_fast_path_is_exact(M):
    """Signed zeros, subnormals, the largest finite values (whose
    difference overflows to inf), near-equal neighbours: the subtraction
    rule equals the comparisons of the plain version exactly."""
    edge = np.array([0.0, -0.0, 1e-45, -1e-45, 3e-45, 1.1754942e-38,
                     -1.1754942e-38, 1.0, -1.0, 1.0000001, 0.99999994,
                     3.4028235e38, -3.4028235e38, 1e30, -1e30, 0.5],
                    np.float32)
    rng = np.random.default_rng(M)
    F = np.where(rng.random((400, M)) < 0.7,
                 rng.choice(edge, (400, M)),
                 rng.standard_normal((400, M)).astype(np.float32))
    F = F.astype(np.float32)
    F[1] = F[0]
    Fc = F + np.float32(0.0)                # as the kernel stages them
    assert not np.signbit(Fc[Fc == 0]).any()
    got = _fast_path(Fc[:, None, :], Fc[None, :, :])
    want = ref.dominance_matrix(torch.from_numpy(F)).numpy()
    np.testing.assert_array_equal(got, want)


def _chunked(F: np.ndarray, chunk: int = 32, cols: int = COLS,
             rows: int = 16) -> np.ndarray:
    """The chunked kernels' plan (M > 32; up to 32 it is one chunk), for
    the matrix kernel (a thread's 16 columns as bits, a batch of rows) and
    the counts kernel (a tile's rows as bits): the objectives taken
    ``chunk`` at a time, one word of
    "all <=" bits and one of "any <" bits per row across the chunks, the
    entry the AND of the two once every chunk is seen."""
    P, M = F.shape
    out = np.zeros((P, P), bool)
    for i0 in range(0, P, rows):
        for j0 in range(0, P, cols):
            fi, fj = F[i0:i0 + rows], F[j0:j0 + cols]
            le = np.full(len(fi), (1 << len(fj)) - 1, np.uint32)
            lt = np.zeros(len(fi), np.uint32)
            bit = np.uint32(1) << np.arange(len(fj), dtype=np.uint32)
            for m0 in range(0, M, chunk):
                for m in range(m0, min(M, m0 + chunk)):
                    a, b = fi[:, m, None], fj[None, :, m]
                    le &= ((a <= b) * bit).sum(axis=1, dtype=np.uint32)
                    lt |= ((a < b) * bit).sum(axis=1, dtype=np.uint32)
            dom = le & lt
            out[i0:i0 + rows, j0:j0 + cols] = (dom[:, None] & bit) != 0
    return out


@pytest.mark.parametrize("M", [9, 32, 33, 64, 70])
def test_dominance_chunked_objectives_are_exact(M):
    """Past 32 objectives the chunked kernels carry their bits across
    chunks of 32: with ties, +-inf, NaN and signed zeros the plan gives the plain
    version's matrix and column sums exactly."""
    rng = np.random.default_rng(M)
    F = (np.round(rng.random((70, M)) * 4) / 4).astype(np.float32)
    F[5] = F[3]
    F[7, M - 1] = np.nan
    F[9, 0], F[10, M // 2], F[11, M - 1] = np.inf, -np.inf, -0.0
    F[12] = F[0]
    F[12, 40 % M] -= 0.25                   # differs past the first chunk
    want = ref.dominance_matrix(torch.from_numpy(F)).numpy()
    got = _chunked(F)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    np.testing.assert_array_equal(
        got.sum(axis=0, dtype=np.int32),
        ref.dominance_counts(torch.from_numpy(F)).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        dominance.dominance_matrix_cuda(torch.from_numpy(F))
