"""Time this checkout's dominance kernels against another checkout's, in
alternating turns on one card.

    PYTHONPATH=src python -m repro_torch.kernels.dominance_ab OTHER [--out F]

OTHER is the root of another checkout of the repository (a parent commit
unpacked by ``git archive``, say). Each side's ``csrc/dominance.cu`` is built
alone with :data:`_build.NVCC_FLAGS` into a library of its own (under the
repository's ``build/``, removed at the end), and each is called through the
C signatures that its own ``_build.py`` declares, on the same inputs and,
where the signature takes one, this checkout's grids (before the host chose
the counts grid, the counts entry was ``(F, C, P, M, stream)``). A case
(kernel, P, M) runs other, this, this, other for ``--rounds`` rounds; a
turn is the median device time of the kernel over 20 launches
from torch.profiler, beside the device operations a call runs (a memset
counts) and their device time together. Both sides' outputs must be equal.
Prints the card's name and power limit, then one JSON line per case (times
in ms), and writes them all to ``--out`` when given. A case that the other
side refuses (M > 32 in a build without the chunked kernel) runs on this
side only.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
                (4096, 32), (4096, 33), (1024, 3), (2048, 3))


NAMES = ("repro_dominance_matrix", "repro_dominance_counts")


def signatures(root: Path) -> dict:
    """The ctypes signatures that the checkout at ``root`` declares for the
    dominance entry points: its ``kernels/_build.py``, loaded as a module of
    its own."""
    path = root / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("_ab_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: list(mod.SYMBOLS[name]) for name in NAMES}


def build_library(csrc: Path, out_dir: Path, symbols: dict) -> ctypes.CDLL:
    """``csrc/dominance.cu`` alone, compiled and linked into ``out_dir``,
    its entry points given the ctypes signatures ``symbols``."""
    nvcc = _build.find_nvcc()
    obj, so = out_dir / "dominance.o", out_dir / "libdominance.so"
    _build._run_all([_build.compile_command(nvcc, csrc / "dominance.cu",
                                            obj)])
    _build._run_all([_build.link_command(nvcc, [obj], so)])
    lib = ctypes.CDLL(str(so))
    for name in NAMES:
        fn = getattr(lib, name)
        fn.argtypes = symbols[name]
        fn.restype = ctypes.c_int
    return lib


def launcher(lib: ctypes.CDLL, kernel: str, F: torch.Tensor):
    """A call of ``lib``'s kernel on F into a fresh output; returns the
    output, or None when the entry point refuses the shapes."""
    P, M = F.shape
    stream = _build.stream(F.device)
    n_sm = _build.n_sm(F.device)
    if kernel == "matrix":
        grid = dominance.dominance_grid(P, n_sm)

        def call():
            out = torch.empty((P, P), dtype=torch.uint8, device=F.device)
            err = lib.repro_dominance_matrix(F.data_ptr(), out.data_ptr(), P,
                                             M, *grid, stream)
            return None if err else out
    else:
        # (F, C, P, M, stream): the entry that chose its grid itself
        takes_grid = len(lib.repro_dominance_counts.argtypes) > 5
        grid = dominance.dominance_counts_grid(P, n_sm) if takes_grid else ()

        def call():
            out = torch.empty((P,), dtype=torch.int32, device=F.device)
            err = lib.repro_dominance_counts(F.data_ptr(), out.data_ptr(), P,
                                             M, *grid, stream)
            return None if err else out
    return call


def device_ms(call, name: str, iters: int = 20):
    """(median device time of the kernel whose name holds ``name``, device
    operations a call, their device time a call) over ``iters`` calls, in
    ms (a window without device activity is profiled again)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        evs = [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
               if ev.device_type.name == "CUDA"]
        us = [t for n, t in evs if name in n]
        if us:
            return (statistics.median(us) / 1e3, len(evs) / iters,
                    sum(t for _, t in evs) / iters / 1e3)
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
        ops, totals = {}, {side: [] for side in set(order)}
        for _ in range(rounds):
            for side in order:
                t, ops[side], total = device_ms(calls[side], name)
                times[side].append(t)
                totals[side].append(total)
        row = {"kernel": kernel, "P": P, "M": M}
        for side in sorted(times):
            row[f"{side}_ms"] = times[side]
            row[f"{side}_ops_per_call"] = ops[side]
            row[f"{side}_all_ops_ms"] = totals[side]
        if "other" in times:
            row["speedup"] = (statistics.median(times["other"])
                              / statistics.median(times["this"]))
        yield row


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
        this = build_library(_build.CSRC, Path(tmp) / "this",
                             {name: _build.SYMBOLS[name] for name in NAMES})
        other = build_library(other_csrc, Path(tmp) / "other",
                              signatures(args.other))
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
