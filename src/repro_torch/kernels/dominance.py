"""Pareto dominance: the CUDA kernels' wrappers.

The kernels (``csrc/dominance.cu``) replace the TPU kernels
``dominance_matrix_pallas`` and ``dominance_counts_pallas`` of
``src/repro/kernels/dominance.py``; the source notes say what bounds each and
how the design answers. A wrapper checks the input, allocates the output,
launches on PyTorch's current stream and counts the launch. They take CUDA
tensors only: the dispatch by device lives in ``kernels.ops``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _build

#: columns of D one block of the matrix kernel covers: 32 lanes x 16
STRIP = 512
#: warps of a matrix block, taking the rows of its split in turns
ROW_WARPS = 8
#: consecutive columns a thread of the counts kernels owns
COUNT_COLS = 8
#: threads of a counts block: its column groups x its row phases
COUNT_THREADS = 512
#: the most column groups of a counts block (32 columns)
MAX_GROUPS = 4
#: the most rows of the counts ballot kernel: a lane a row, one block
BALLOT_ROWS = 1024
#: the counts kernels, as the C entry takes them: the ballot kernel (P up to
#: :data:`BALLOT_ROWS`) and the kernels over tiles of rows
COUNTS_BALLOT, COUNTS_TILES = 0, 1

#: matrix kernel launches since the last reset (a run sets it to 0, then
#: reads it)
LAUNCHES = 0
#: counts kernel launches since the last reset
COUNTS_LAUNCHES = 0


def _objectives(name: str, F: torch.Tensor) -> torch.Tensor:
    """F checked, cast to f32 (as the TPU kernels do) and contiguous; an
    f32 contiguous F is taken as it is."""
    if F.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {F.device}")
    if F.dim() != 2 or not F.is_floating_point():
        raise ValueError(f"F must be a 2-D floating tensor, got "
                         f"{tuple(F.shape)} {F.dtype}")
    P, M = F.shape
    if P < 1 or M < 1:
        raise ValueError(f"need P >= 1 and M >= 1, got P={P}, M={M}")
    if F.dtype != torch.float32 or not F.is_contiguous():
        F = F.to(torch.float32).contiguous()
    return F


@functools.lru_cache(maxsize=256)
def dominance_grid(P: int, n_sm: int) -> Tuple[int, int, int]:
    """(strips, splits, rows): the matrix kernel's grid. The columns go to
    ``strips`` blocks of :data:`STRIP`, the rows to ``splits`` runs of
    ``rows`` each, a multiple of :data:`ROW_WARPS`.

    As ``decode_attention.decode_split`` does for positions: the most row
    splits that keep the grid at about two blocks per SM (8 strips x 32
    splits of 128 rows at P = 4096 on 132 SMs), so each block walks a long
    run of rows and stages its columns once; no split gets fewer rows than
    its warps."""
    strips = -(-P // STRIP)
    want = min(-(-2 * n_sm // strips), -(-P // ROW_WARPS))
    rows = ROW_WARPS * -(-P // (ROW_WARPS * want))
    return strips, -(-P // rows), rows


@functools.lru_cache(maxsize=256)
def dominance_counts_grid(P: int, n_sm: int) -> Tuple[int, int, int]:
    """(kernel, blocks, cols): the counts kernel and its grid, ``blocks``
    blocks of ``cols`` columns, each against every row.

    Up to :data:`BALLOT_ROWS` rows, :data:`COUNTS_BALLOT`: a lane a row, 4
    columns a block where those blocks fit the SMs in one wave, else 8 (50
    blocks at P = 200, 128 of 8 at P = 1024 on 132 SMs). Past it,
    :data:`COUNTS_TILES`: blocks of 4, 2 or 1 groups of :data:`COUNT_COLS`
    columns, whose :data:`COUNT_THREADS` threads are the groups times the
    row phases. An SM holds one such block, so the grid is kept to one
    wave: the widest block whose grid covers three quarters of the SMs and
    no more than all of them, else the grid of most blocks within one wave,
    else (past 32 columns an SM) the widest. A wider block reads F from L2
    fewer times over and sums fewer phases (128 blocks of 32 columns at P =
    4096, 69 of 16 at P = 1100)."""
    if P <= BALLOT_ROWS:
        cols = 4 if -(-P // 4) <= n_sm else 8
        return COUNTS_BALLOT, -(-P // cols), cols
    grids = [(-(-P // (COUNT_COLS * g)), g) for g in (MAX_GROUPS, 2, 1)]
    one_wave = [(b, g) for b, g in grids if b <= n_sm]
    for blocks, groups in one_wave:
        if 4 * blocks >= 3 * n_sm:
            break
    else:
        blocks, groups = one_wave[-1] if one_wave else grids[0]
    return COUNTS_TILES, blocks, COUNT_COLS * groups


def dominance_matrix_cuda(F: torch.Tensor) -> torch.Tensor:
    """(P, M) floating objectives on a CUDA device -> (P, P) bool.

    The kernel writes uint8 and the result is a ``torch.bool`` view of it."""
    global LAUNCHES
    F32 = _objectives("dominance_matrix_cuda", F)
    P, M = F32.shape
    out = torch.empty((P, P), dtype=torch.uint8, device=F.device)
    grid = dominance_grid(P, _build.n_sm(F.device))
    lib = _build.load()
    with _build.on_device(F.device):
        err = lib.repro_dominance_matrix(F32.data_ptr(), out.data_ptr(), P,
                                         M, *grid, _build.stream(F.device))
    if err != 0:
        raise RuntimeError(f"dominance kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out.view(torch.bool)


def dominance_counts_cuda(F: torch.Tensor) -> torch.Tensor:
    """(P, M) floating objectives on a CUDA device -> (P,) int32, the number
    of rows dominating each row; the (P, P) matrix is never stored. One
    launch and no other device operation: the kernel writes every count."""
    global COUNTS_LAUNCHES
    F32 = _objectives("dominance_counts_cuda", F)
    P, M = F32.shape
    out = torch.empty((P,), dtype=torch.int32, device=F.device)
    grid = dominance_counts_grid(P, _build.n_sm(F.device))
    lib = _build.load()
    with _build.on_device(F.device):
        err = lib.repro_dominance_counts(F32.data_ptr(), out.data_ptr(), P,
                                         M, *grid, _build.stream(F.device))
    if err != 0:
        raise RuntimeError(f"dominance counts kernel launch failed: "
                           f"cudaError {err}")
    COUNTS_LAUNCHES += 1
    return out
