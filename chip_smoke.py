#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and runs
the routing loop on the card, in phases that each print one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time;
2. kernels: every kernel against its plain PyTorch version on the card
   (exact), and its time beside the plain version's and the card's bound;
3. main path: ``repro_torch.quickstart.run_quickstart()`` at full size (500
   requests, pop 100, 60 generations); the dominance kernel must launch
   exactly 61 times (init + 60 generations);
   then one population evaluation is profiled (host wall time against the
   card's busy time);
4. device against CPU: the same evaluator on the card and on the CPU must
   route every request identically;
5. large population: a direct-assignment NSGA-II at a combined population
   of 4096 over the same trace, kernel on.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure raises and exits non-zero. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing anything.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
DOM_CASES_P = (1, 7, 100, 130, 200, 1000, 4096, 4099)
DOM_CASES_M = (1, 2, 3, 4, 8)
QUICKSTART = dict(n_requests=500, pop_size=100, n_generations=60)
LARGE_POP, LARGE_GENS = 2048, 5


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, *args, iters=50, reps=7):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn(*args)
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def device_kernel_ms(fn, *args, name="dominance_matrix_kernel", iters=20):
    """Median device time of the named kernel from torch.profiler, or None
    when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if name in ev.name and ev.device_type.name == "CUDA"]
    return statistics.median(us) / 1e3 if us else None


def dominance_bound_ms(P, M):
    """Least time for the function: F read once (P*M*4 bytes), D written
    once (P*P bytes), 2*P*P*M f32 comparisons."""
    return 1e3 * max((P * M * 4 + P * P) / HBM_BYTES_PER_S,
                     2 * P * P * M / F32_OPS_PER_S)


def phase_card():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": _build.BUILD_SECONDS, "kernel_load_s": load_s})
    return smi


def _dominance_input(P, M, dtype, gen):
    import torch
    F = torch.round(torch.rand((P, M), generator=gen) * 8) / 8   # ties
    if P > 3:
        F[P // 2] = F[0]                  # a duplicated row
        F[P - 1, M - 1] = float("nan")    # a NaN row
    return F.to(dtype).cuda()


def phase_kernels():
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(0)
    n_cases = n_exact = 0
    max_err = 0
    for P in DOM_CASES_P:
        for M in DOM_CASES_M:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                F = _dominance_input(P, M, dtype, gen)
                got = ops.dominance_matrix(F)
                torch.cuda.synchronize()
                want = ref.dominance_matrix(F)
                assert got.dtype == torch.bool and got.shape == (P, P)
                err = int((got.to(torch.int8) - want.to(torch.int8)).abs()
                          .max())
                max_err = max(max_err, err)
                n_cases += 1
                n_exact += bool(torch.equal(got, want))
    assert n_exact == n_cases, f"kernel != plain in {n_cases - n_exact} cases"
    timing = {}
    for P in (200, 4096):
        F = torch.rand((P, 3), device="cuda")
        timing[P] = dict(
            ms=time_ms(ops.dominance_matrix, F),
            plain_ms=time_ms(ref.dominance_matrix, F),
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(P, 3))
    row = {"phase": "kernels", "name": "dominance_matrix", "cases": n_cases,
           "exact": n_exact == n_cases, "max_abs_err": max_err,
           "timing": {str(P): t for P, t in timing.items()}}
    emit(row)
    return row


def phase_main_path():
    import numpy as np
    from repro_torch.kernels import dominance
    from repro_torch.quickstart import format_table, run_quickstart
    dominance.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_quickstart(**QUICKSTART)
    wall = time.perf_counter() - t0
    launches = dominance.LAUNCHES
    expected = 1 + QUICKSTART["n_generations"]
    assert launches == expected, f"{launches} launches, want {expected}"
    F = res.state.F_raw.cpu().numpy()
    assert F.shape == (QUICKSTART["pop_size"], 3) and np.isfinite(F).all()
    for r in res.rows.values():
        assert all(math.isfinite(v) for v in r.values()), r
    assert int(res.state.rank[res.index]) == 0
    assert float(res.state.violation[res.index]) <= 0
    print(format_table(res), flush=True)
    emit({"phase": "main_path", "launches": {"dominance_matrix": launches},
          "evolve_s": res.evolve_s, "wall_s": wall, "rows": res.rows,
          "overall": res.overall, "genome": res.genome})
    return res, launches


def phase_profile(genomes):
    """Where one population evaluation of the main path spends its time:
    host wall time against the card's busy time (torch.profiler)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.workload.trace import build_trace
    ev = TraceEvaluator(build_trace(500, seed=0), paper_testbed(),
                        EvalConfig(concurrency=1), device="cuda")
    fit = ev.make_fitness("threshold")
    fit(genomes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(genomes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fit(genomes)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    n_events = 0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            n_events += 1
    busy = sum(by_name.values()) / 1e6
    emit({"phase": "profile", "what": "one fitness call, pop "
          f"{genomes.shape[0]} x 500 requests", "wall_s": wall,
          "device_busy_s": busy, "idle_share": 1 - busy / wall,
          "device_events": n_events, "us_per_request_step": wall / 500 * 1e6,
          "top_device_us": by_name.most_common(6)})


def phase_device_vs_cpu(genome):
    import torch
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.policies.threshold import BOUNDS_HI, BOUNDS_LO
    from repro_torch.workload.trace import build_trace
    trace, cluster = build_trace(500, seed=0), paper_testbed()
    g = torch.Generator().manual_seed(1)
    lo, hi = torch.from_numpy(BOUNDS_LO), torch.from_numpy(BOUNDS_HI)
    G = torch.cat([torch.as_tensor(genome)[None],
                   lo + torch.rand((32, 6), generator=g) * (hi - lo)])
    out = {"phase": "device_vs_cpu", "genomes": int(G.shape[0])}
    for conc in (1, 4):
        cfg = EvalConfig(concurrency=conc)
        dev = TraceEvaluator(trace, cluster, cfg, device="cuda")
        cpu = TraceEvaluator(trace, cluster, cfg, device="cpu")
        a = dev.run_population("threshold", G)
        b = cpu.run_population("threshold", G)
        mism = int((a.assign.cpu() != b.assign).sum())
        rel = 0.0
        for f in ("q", "cost", "rt", "ttft", "tpot"):
            x, y = getattr(a, f).cpu(), getattr(b, f)
            assert torch.allclose(x, y, rtol=1e-5, atol=1e-6), f
            rel = max(rel, float(((x - y).abs() / y.abs().clamp(min=1e-12))
                                 .max()))
        assert mism == 0, f"{mism} assignment mismatches at concurrency {conc}"
        out[f"concurrency_{conc}"] = {"assign_mismatches": mism,
                                      "max_rel_err": rel}
    emit(out)


def phase_large_population():
    import torch
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.baselines import heuristic_bias_init
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.nsga2 import NSGA2, NSGA2Config
    from repro_torch.kernels import dominance
    from repro_torch.workload.trace import build_trace
    trace, cluster = build_trace(500, seed=0), paper_testbed()
    ev = TraceEvaluator(trace, cluster, EvalConfig(concurrency=1),
                        device="cuda")
    cfg = NSGA2Config(pop_size=LARGE_POP, n_generations=LARGE_GENS,
                      genome="discrete", n_choices=cluster.n_pairs,
                      genome_length=trace.n_requests)
    pop = heuristic_bias_init(trace, cluster, LARGE_POP, seed=0)
    opt = NSGA2(ev.make_fitness("direct"), cfg,
                init_fn=lambda _: torch.as_tensor(pop, device="cuda"),
                device="cuda")
    stamps = []

    def tick(_state=None):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    dominance.LAUNCHES = 0
    tick()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = opt.evolve(gen, LARGE_GENS, callback=tick)
    launches = dominance.LAUNCHES
    assert launches == 1 + LARGE_GENS, f"{launches} launches"
    assert state.genomes.shape == (LARGE_POP, trace.n_requests)
    assert bool(torch.isfinite(state.F_raw).all())
    per_gen = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    emit({"phase": "large_population", "pop": LARGE_POP,
          "combined": 2 * LARGE_POP, "generations": LARGE_GENS,
          "launches": launches, "init_plus_first_gen_s": stamps[1] - stamps[0],
          "gen_s": per_gen, "median_gen_s": statistics.median(per_gen),
          "front0": int((state.rank == 0).sum())})
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA device; it runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    phase_s = {}
    t = time.perf_counter()
    smi = phase_card()
    phase_s["card"] = time.perf_counter() - t
    t = time.perf_counter()
    kern = phase_kernels()
    phase_s["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    res, launches = phase_main_path()
    phase_s["main_path"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_profile(res.state.genomes)
    phase_s["profile"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_device_vs_cpu(res.genome)
    phase_s["device_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    large = phase_large_population()
    phase_s["large_population"] = time.perf_counter() - t
    emit({"phase": "times", "card": smi, "seconds": phase_s})

    t200, t4096 = kern["timing"]["200"], kern["timing"]["4096"]
    emit({"kernels": [{
        "name": "dominance_matrix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dominance.cu",
        "replaces": "src/repro/kernels/dominance.py:47",
        "launches": launches, "launches_large_population": large,
        "cases": kern["cases"], "exact": kern["exact"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t200["ms"], "plain_ms": t200["plain_ms"],
        "bound_ms": t200["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": t200["device_ms"],
        "p4096": {**t4096, "bound_by": "bytes"}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
