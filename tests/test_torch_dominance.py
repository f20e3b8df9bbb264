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


# ---------------------------------------------------------------------------
# The dominator-counts kernels' plan: the grid that
# ``dominance.dominance_counts_grid`` picks; up to 1,024 rows the ballot
# kernel (a lane a row, blocks of 4 or 8 columns, a warp's ballot per column
# counted by popc, the warps summed), past it blocks of 1, 2 or 4 groups of 8
# columns, every row, the block's threads as groups x row phases, the
# double-buffered tiles of rows taken in a ring from the block's own first
# tile, the byte counters and their flush every 16 tiles, the chunked
# kernel's words across chunks of 32 objectives and batches of 2 rows a
# phase, and the block's sum over its phases, stored once a column.

INV255 = 0xFEFEFEFF       # 255 * INV255 == 1 (mod 2**32)
FLUSH_TILES = 16          # tiles between flushes (kCountFlush)
TILE_BYTES = 16384        # a staged tile (kCountTileBytes)


def _sign_words(dom: np.ndarray) -> np.ndarray:
    """``sign_bytes``: (..., 4) bools -> uint32 words whose byte k is 0xFF
    where dom[..., k], else 0."""
    shift = (8 * np.arange(4)).astype(np.uint64)
    return (dom.astype(np.uint64) * 0xFF << shift).sum(-1).astype(np.uint32)


def _words(a: np.ndarray, b: np.ndarray, fast: bool) -> np.ndarray:
    """x for rows a (R, m) against columns b (C, m), OR-ed over the m
    objectives: the differences' bits (the finite path) or the comparisons'
    word (all ones where not a <= b, else 1 where a < b). Neither is ever
    INT_MIN (whose negation keeps its sign), nor is an OR of them."""
    with np.errstate(over="ignore", invalid="ignore"):
        if fast:
            d = (b[None] - a[:, None]).astype(np.float32).view(np.uint32)
        else:
            le = a[:, None] <= b[None]
            lt = a[:, None] < b[None]
            d = (np.uint32(0) - (~le).astype(np.uint32)) \
                | lt.astype(np.uint32)
    x = np.bitwise_or.reduce(d, axis=-1)
    assert not (x == np.uint32(2 ** 31)).any()
    return x


def _positive(x: np.ndarray) -> np.ndarray:
    """The sign bit of -x (uint32, wrapping): x > 0 as an int."""
    return ((np.uint32(0) - x) >> np.uint32(31)).astype(bool)


def _by_phase(v: np.ndarray, phases: int) -> np.ndarray:
    """(R, ...) -> (phases, ...): row r's values added into phase r %
    phases (uint64, exact)."""
    R = len(v)
    pad = np.zeros((-R % phases,) + v.shape[1:], v.dtype)
    return np.concatenate([v, pad]).reshape(
        -1, phases, *v.shape[1:]).sum(0, dtype=np.uint64)


def _block_counts(Fc, cols, block, groups, tile, flush, threads):
    """Block ``block`` of ``dominance_counts_kernel`` (M <= 8): every
    thread's 8 counts (phases, groups * 8). The block starts on tile
    ``block % tiles`` and takes the tiles in a ring; a tile, or a group's
    columns, with a non-finite value takes the comparisons."""
    P, M = Fc.shape
    phases = threads // groups
    gfinite = np.isfinite(cols).reshape(groups, -1).all(1)
    acc = np.zeros((phases, 2 * groups), np.uint64)
    count = np.zeros((phases, 8 * groups), np.int64)
    tiles = list(range(0, P, tile))
    first = block % len(tiles)
    tiles = tiles[first:] + tiles[:first]
    for n, t0 in enumerate(tiles):
        rows = Fc[t0:t0 + tile]                     # a staged tile
        fast = np.repeat(np.isfinite(rows).all() & gfinite, 8)
        with np.errstate(invalid="ignore"):
            slow = ((rows[:, None] <= cols[None]).all(-1)
                    & (rows[:, None] < cols[None]).any(-1))
        dom = np.where(fast, _positive(_words(rows, cols, True)), slow)
        acc += _by_phase(_sign_words(dom.reshape(len(rows), -1, 4)), phases)
        if n % flush == flush - 1 or n == len(tiles) - 1:
            w = (acc % 2 ** 32) * INV255 % 2 ** 32
            count += ((w[..., None] >> (8 * np.arange(4, dtype=np.uint64)))
                      & 0xFF).reshape(phases, -1).astype(np.int64)
            acc[:] = 0
    return count


def _block_counts_chunked(Fc, cols, groups, threads, chunk=32, batch=2):
    """One block of ``dominance_counts_chunked_kernel`` (M > 8): batches of
    2 rows a phase, x OR-ed over chunks of ``chunk`` objectives, each chunk
    finite (the staged columns and rows of the batch) or compared."""
    P, M = Fc.shape
    phases = threads // groups
    rows_b = batch * phases
    count = np.zeros((phases, 8 * groups), np.int64)
    for b0 in range(0, P, rows_b):
        rows = np.zeros((rows_b, M), np.float32)    # rows past P: zeros
        nb = min(rows_b, P - b0)
        rows[:nb] = Fc[b0:b0 + nb]
        x = np.zeros((rows_b, len(cols)), np.uint32)
        for m0 in range(0, M, chunk):
            rc, cc = rows[:, m0:m0 + chunk], cols[:, m0:m0 + chunk]
            fast = np.isfinite(rc).all() and np.isfinite(cc).all()
            x |= _words(rc, cc, fast)
        count += _by_phase(_positive(x[:nb]), phases).astype(np.int64)
    return count


def _ballot_counts(F, cols, C, writes):
    """``dominance_counts_ballot_kernel`` over F (P <= 1,024) in blocks of
    ``cols`` columns: the block's lanes are the rows (those past P dominate
    nothing); for each column, each warp's ballot of the rows dominating it
    is counted (popc), and the warps' counts are summed and stored once."""
    P, M = F.shape
    threads = 32 * -(-P // 32)
    assert threads <= dominance.BALLOT_ROWS
    rows = np.full((threads, M), np.nan, np.float32)
    rows[:P] = F
    for j0 in range(0, P, cols):
        ncol = min(cols, P - j0)
        red = np.zeros((threads // 32, cols), np.int64)
        for c in range(ncol):
            col = F[j0 + c]
            with np.errstate(invalid="ignore"):
                vote = (rows <= col).all(1) & (rows < col).any(1)
            red[:, c] = vote.reshape(-1, 32).sum(1)     # popc of a ballot
        C[j0:j0 + ncol] = red.sum(0)[:ncol]
        writes[j0:j0 + ncol] += 1
    return C, writes


def _rehearse_counts(F, n_sm=N_SM, C=None, tile=None, flush=FLUSH_TILES,
                     threads=dominance.COUNT_THREADS, grid=None):
    """The counts kernels' plan over F (P, M) into C (a fresh buffer of
    garbage when None), on the host's grid unless ``grid`` is given:
    returns C and how often each entry was written."""
    P, M = F.shape
    kernel, blocks, width = grid or dominance.dominance_counts_grid(P, n_sm)
    assert blocks == -(-P // width)
    C = np.full(P, -7, np.int32) if C is None else C
    writes = np.zeros(P, np.int32)
    if kernel == dominance.COUNTS_BALLOT:
        return _ballot_counts(F, width, C, writes)
    assert kernel == dominance.COUNTS_TILES
    groups = width // 8
    tile = tile or TILE_BYTES // (16 if M <= 4 else 32)
    Fc = (F + np.float32(0.0)).astype(np.float32)   # staged: -0 is +0
    for b in range(blocks):
        c0 = b * width
        cols = np.zeros((width, M), np.float32)      # columns past P: zeros
        cols[:min(width, P - c0)] = Fc[c0:c0 + width]
        count = (_block_counts(Fc, cols, b, groups, tile, flush, threads)
                 if M <= 8 else _block_counts_chunked(Fc, cols, groups,
                                                      threads))
        mine = np.arange(min(width, P - c0))
        C[c0 + mine] = count.sum(0)[mine]           # one store a column
        writes[c0 + mine] += 1
    return C, writes


def _count_inputs(P, M, seed):
    """Ties, a duplicated row, -0 against +0, +-inf and NaN in rows (and so
    in columns: they are the same objectives)."""
    rng = np.random.default_rng(seed)
    F = (np.round(rng.random((P, M)) * 4) / 4).astype(np.float32)
    if P > 12:
        F[1] = F[0]
        F[2, 0], F[3] = -0.0, F[2]
        F[3, 0] = 0.0
        F[4, M - 1] = np.inf
        F[5, 0] = -np.inf
        F[6, M // 2] = np.nan
        F[7] = -F[8]
        F[9, :] = 0.0
        F[10, :] = -0.0
    return F


@pytest.mark.parametrize("n_sm", [114, N_SM])
@pytest.mark.parametrize("P", [1, 63, 64, 65, 200, 4096, 4099, 4104, 1025,
                               1100, 1600, 9000])
def test_dominance_counts_grid_covers_each_row_and_column_once(P, n_sm):
    """Every column in exactly one block, and every row counted once for
    each column: a lane of the ballot kernel's block (up to 1,024 rows), or
    one phase of a tile kernel's block, whose grid covers three quarters of
    the SMs in one wave where P allows."""
    kernel, blocks, width = dominance.dominance_counts_grid(P, n_sm)
    assert blocks == -(-P // width)
    cols = np.concatenate([np.arange(b * width, min(P, (b + 1) * width))
                           for b in range(blocks)])
    np.testing.assert_array_equal(cols, np.arange(P))
    if P <= dominance.BALLOT_ROWS:
        assert kernel == dominance.COUNTS_BALLOT and width in (4, 8)
        # 4 columns a block where those blocks fit the SMs in one wave
        assert (width == 4) == (-(-P // 4) <= n_sm)
        lanes = 32 * -(-P // 32)
        assert P <= lanes <= dominance.BALLOT_ROWS
        return
    assert kernel == dominance.COUNTS_TILES
    groups = width // dominance.COUNT_COLS
    assert groups in (1, 2, dominance.MAX_GROUPS)
    assert width == dominance.COUNT_COLS * groups
    phases = dominance.COUNT_THREADS // groups
    seen = np.zeros(P, np.int32)
    for phase in range(phases):
        seen[phase::phases] += 1
    assert (seen == 1).all()
    # the widest block whose grid covers three quarters of the SMs in one
    # wave; else the most blocks in one wave; else the widest
    grids = {g: -(-P // (dominance.COUNT_COLS * g)) for g in (1, 2, 4)}
    good = [g for g, b in grids.items() if 3 * n_sm <= 4 * b <= 4 * n_sm]
    fits = [g for g, b in grids.items() if b <= n_sm]
    want = max(good) if good else min(fits) if fits else max(grids)
    assert groups == want


def test_dominance_counts_grid_at_the_main_path_shapes():
    tiles, ballot = dominance.COUNTS_TILES, dominance.COUNTS_BALLOT
    assert dominance.dominance_counts_grid(4096, 132) == (tiles, 128, 32)
    assert dominance.dominance_counts_grid(4096, 114) == (tiles, 128, 32)
    assert dominance.dominance_counts_grid(2048, 132) == (tiles, 128, 16)
    assert dominance.dominance_counts_grid(1025, 132) == (tiles, 129, 8)
    assert dominance.dominance_counts_grid(1100, 132) == (tiles, 69, 16)
    assert dominance.dominance_counts_grid(1024, 132) == (ballot, 128, 8)
    assert dominance.dominance_counts_grid(200, 132) == (ballot, 50, 4)
    assert dominance.dominance_counts_grid(32, 132) == (ballot, 8, 4)


def test_dominance_counts_constants_match_the_kernel():
    """The plan above uses the Python constants; the kernel its own."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "dominance.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kCountCols") == dominance.COUNT_COLS
    assert const("kCountThreads") == dominance.COUNT_THREADS
    assert const("kMaxGroups") == dominance.MAX_GROUPS
    assert const("kCountFlush") == FLUSH_TILES
    assert const("kCountTileBytes") == TILE_BYTES
    assert const("kCountBatch") == 2 and const("kChunkM") == 32
    assert const("kBallotRows") == dominance.BALLOT_ROWS
    assert (f"kCountsBallot = {dominance.COUNTS_BALLOT}, "
            f"kCountsTiles = {dominance.COUNTS_TILES};") in src
    assert f"kInv255 = {INV255:#X}u".replace("0X", "0x") in src
    assert 255 * INV255 % 2 ** 32 == 1


@pytest.mark.parametrize("P,n_sm", [(200, N_SM), (2100, 8)])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 9, 33])
def test_dominance_counts_plan_is_exact(M, P, n_sm):
    """The plan gives the plain counts exactly with ties, duplicated rows,
    signed zeros, +-inf and NaN; P 200 on the host's grid (the ballot
    kernel) and on blocks of 8 columns over one tile; P 2,100 on 8 SMs
    takes blocks of 32 columns over three or five tiles (several batches
    past 8 objectives)."""
    F = _count_inputs(P, M, 10 * M + P)
    want = ref.dominance_counts(torch.from_numpy(F)).numpy()
    assert want.max() > 0
    for grid in (None, (dominance.COUNTS_TILES, -(-P // 8), 8)):
        got, writes = _rehearse_counts(F, n_sm, grid=grid)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups_n_sm", [132, 300, 600])
def test_dominance_counts_plan_at_the_main_path_shape(groups_n_sm):
    """P 4096, M 3 in blocks of 1, 2 and 4 groups."""
    F = np.round(np.random.default_rng(7).random((4096, 3)) * 8) / 8
    F = F.astype(np.float32)
    F[100, 1] = np.nan
    got, writes = _rehearse_counts(F, groups_n_sm)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        got, ref.dominance_counts(torch.from_numpy(F)).numpy())


def test_dominance_counts_plan_keeps_no_state_between_calls():
    """Every count is written once and none is read: two calls in a row on
    one buffer of garbage give the same counts, with no zeroing between
    (the ballot kernel's grid, then blocks of 32 columns over tiles)."""
    F = _count_inputs(700, 3, 1)
    want = ref.dominance_counts(torch.from_numpy(F)).numpy()
    for grid in (None, (dominance.COUNTS_TILES, -(-700 // 32), 32)):
        buf = np.full(700, 123456, np.int32)
        first, w1 = _rehearse_counts(F, C=buf, grid=grid)
        first = first.copy()
        second, w2 = _rehearse_counts(F, C=buf, grid=grid)
        assert (w1 == 1).all() and (w2 == 1).all()
        np.testing.assert_array_equal(first, second)
        np.testing.assert_array_equal(second, want)


@pytest.mark.parametrize("cols", [4, 8])
@pytest.mark.parametrize("P", [1, 31, 32, 33, 200, 1000, 1024])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 33])
def test_dominance_counts_ballot_plan_is_exact(M, P, cols):
    """The ballot kernel in blocks of 4 and 8 columns (a last block cut by
    P, a last warp part filled) gives the plain counts exactly with ties,
    duplicated rows, signed zeros, +-inf and NaN, each written once."""
    F = _count_inputs(P, M, 7 * M + P)
    got, writes = _rehearse_counts(
        F, grid=(dominance.COUNTS_BALLOT, -(-P // cols), cols))
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        got, ref.dominance_counts(torch.from_numpy(F)).numpy())



def test_dominance_counts_byte_counters_flush_before_they_wrap():
    """A column dominated by every other row (4,095). With the kernel's
    constants a thread counts at most 128 rows between flushes, and the
    counts are exact; a block of 8 threads (2 phases) counting 512 rows of
    a 1,024-row tile a thread would wrap its byte counters, unless they
    were flushed after fewer rows (tiles of 256 rows, every tile)."""
    P = 4096
    F = np.repeat(np.arange(P, 0, -1, dtype=np.float32)[:, None], 3, 1)
    want = np.arange(P - 1, -1, -1, dtype=np.int32)   # the rows after j
    got, _ = _rehearse_counts(F)
    np.testing.assert_array_equal(got, want)
    assert want[0] == P - 1 >= 255
    for groups in (1, 2, dominance.MAX_GROUPS):   # rows a thread counts
        for row_bytes in (16, 32):                 # between flushes
            tile = TILE_BYTES // row_bytes
            per = -(-tile // (dominance.COUNT_THREADS // groups))
            assert FLUSH_TILES * per <= 255
    # one SM: blocks of 4 groups, so 8 threads are 2 phases
    wrapped, _ = _rehearse_counts(F[:1100], 1, threads=8, tile=1024)
    assert wrapped[0] != 1099
    small, _ = _rehearse_counts(F[:1100], 1, threads=8, tile=256, flush=1)
    np.testing.assert_array_equal(small, want[-1100:])


def test_dominance_counts_byte_counter_arithmetic():
    """Adding ``sign_bytes`` words puts 255 x each byte's count into the
    word, mod 2^32; the multiply by 255's inverse reads the four counts
    back exactly while none passes 255."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        dom = rng.random((255, 4)) < rng.random(4)
        acc = int(_sign_words(dom).sum(dtype=np.uint64)) % 2 ** 32
        n = acc * INV255 % 2 ** 32
        assert [(n >> 8 * k) & 0xFF for k in range(4)] == \
            list(dom.sum(0))
    # 256 in byte 0 reads back as 0 in byte 0 and 1 in byte 1
    dom = np.zeros((256, 4), bool)
    dom[:, 0] = True
    over = _sign_words(dom).sum(dtype=np.uint64)
    assert int(over) % 2 ** 32 * INV255 % 2 ** 32 == 0x100
    # the three permutes of sign_bytes (pack_signs without its mask)
    for _ in range(200):
        y = [int(v) for v in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
        w = _prmt(_prmt(y[0], y[1], 0x00FB), _prmt(y[2], y[3], 0x00FB),
                  0x5410)
        assert w == int(_sign_words(np.array([v >> 31 for v in y], bool)))


def test_dominance_ab_reads_each_sides_signatures(tmp_path):
    """The A/B script calls the other checkout through the signatures its
    own ``_build.py`` declares (here the five-argument counts entry that
    chose its grid itself), and refuses a checkout without one."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels import _build, dominance_ab
    root = Path(_build.__file__).resolve().parents[3]
    sig = dominance_ab.signatures(root)
    assert sig == {n: _build.SYMBOLS[n] for n in dominance_ab.NAMES}
    other = tmp_path / "src" / "repro_torch" / "kernels"
    other.mkdir(parents=True)
    (other / "_build.py").write_text(
        "import ctypes\n_P, _I = ctypes.c_void_p, ctypes.c_int\n"
        "SYMBOLS = {'repro_dominance_counts': [_P, _P, _I, _I, _P],\n"
        "           'repro_dominance_matrix': [_P, _P] + [_I] * 5 + [_P]}\n")
    old = dominance_ab.signatures(tmp_path)
    assert old["repro_dominance_counts"] == [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    with pytest.raises(FileNotFoundError):
        dominance_ab.signatures(tmp_path / "absent")
