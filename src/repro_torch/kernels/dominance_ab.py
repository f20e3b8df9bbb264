"""Time this checkout's dominance kernels against another checkout's, in
alternating turns on one card.

    PYTHONPATH=src python -m repro_torch.kernels.dominance_ab OTHER [--out F]

OTHER is the root of another checkout of the repository (a parent commit
unpacked by ``git archive``, say). Each side's ``csrc/dominance.cu`` is built
alone with :data:`_build.NVCC_FLAGS` into a library of its own (under the
repository's ``build/``, removed at the end), and both are
called through the same C signatures on the same inputs and grids. A case
(kernel, P, M) runs other, this, this, other for ``--rounds`` rounds; a turn
is the median device time of the kernel over 20 launches from
torch.profiler. Both sides' outputs must be equal. Prints the card's name
and power limit, then one JSON line per case (times in ms), and writes them
all to ``--out`` when given. A case that the other side refuses (M > 32 in
a build without the chunked kernel) runs on this side only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from . import _build, dominance

MATRIX_CASES = ((32, 4), (64, 4), (200, 3), (4096, 3), (200, 9), (4096, 9),
                (200, 32), (4096, 32), (200, 33), (4096, 64))
COUNTS_CASES = ((200, 3), (4096, 3), (200, 9), (4096, 9), (200, 32),
                (4096, 32), (4096, 33))


def build_library(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """``csrc/dominance.cu`` alone, compiled and linked into ``out_dir``."""
    nvcc = _build.find_nvcc()
    obj, so = out_dir / "dominance.o", out_dir / "libdominance.so"
    _build._run_all([_build.compile_command(nvcc, csrc / "dominance.cu",
                                            obj)])
    _build._run_all([_build.link_command(nvcc, [obj], so)])
    lib = ctypes.CDLL(str(so))
    for name in ("repro_dominance_matrix", "repro_dominance_counts"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SYMBOLS[name]
        fn.restype = ctypes.c_int
    return lib


def launcher(lib: ctypes.CDLL, kernel: str, F: torch.Tensor):
    """A call of ``lib``'s kernel on F into a fresh output; returns the
    output, or None when the entry point refuses the shapes."""
    P, M = F.shape
    stream = _build.stream(F.device)
    if kernel == "matrix":
        grid = dominance.dominance_grid(P, _build.n_sm(F.device))

        def call():
            out = torch.empty((P, P), dtype=torch.uint8, device=F.device)
            err = lib.repro_dominance_matrix(F.data_ptr(), out.data_ptr(), P,
                                             M, *grid, stream)
            return None if err else out
    else:
        def call():
            out = torch.empty((P,), dtype=torch.int32, device=F.device)
            err = lib.repro_dominance_counts(F.data_ptr(), out.data_ptr(), P,
                                             M, stream)
            return None if err else out
    return call


def device_ms(call, name: str, iters: int = 20) -> float:
    """Median device time of the kernel whose name holds ``name`` over
    ``iters`` calls (a window without device activity is profiled again)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type.name == "CUDA" and name in ev.name]
        if us:
            return statistics.median(us) / 1e3
    raise RuntimeError(f"the profiler recorded no {name} kernel")


def compare(this: ctypes.CDLL, other: ctypes.CDLL, rounds: int):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = ([("matrix", P, M) for P, M in MATRIX_CASES]
             + [("counts", P, M) for P, M in COUNTS_CASES])
    for kernel, P, M in cases:
        F = torch.rand((P, M), device="cuda", generator=gen)
        F = torch.round(F * 8) / 8   # ties, as the sorts see them
        calls = {"this": launcher(this, kernel, F),
                 "other": launcher(other, kernel, F)}
        want = calls["this"]()
        assert want is not None, (kernel, P, M, "refused by this build")
        got = calls["other"]()
        if got is None:
            order = ["this"] * 2
        else:
            assert torch.equal(got, want), (kernel, P, M, "outputs differ")
            order = ["other", "this", "this", "other"]
        name = f"dominance_{kernel}"
        times = {side: [] for side in set(order)}
        for _ in range(rounds):
            for side in order:
                times[side].append(device_ms(calls[side], name))
        yield {"kernel": kernel, "P": P, "M": M, **{
            f"{side}_ms": t for side, t in sorted(times.items())}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    other_csrc = args.other / "src" / "repro_torch" / "kernels" / "csrc"
    _build.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT.parent) as tmp:
        (Path(tmp) / "this").mkdir()
        (Path(tmp) / "other").mkdir()
        this = build_library(_build.CSRC, Path(tmp) / "this")
        other = build_library(other_csrc, Path(tmp) / "other")
        rows = []
        for row in compare(this, other, args.rounds):
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "cases": rows},
                                       indent=1))


if __name__ == "__main__":
    main()
