#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and runs
the port's paths on the card, the routing loop, the serving engine and its
prefix reuse on session traffic, the runtime router's rolling-horizon
re-fit on open-loop SLO traffic, the whole policy registry on the policy
matrix, and the cluster server end to end, in phases that each print one
JSON line (run in the order 1-5, 9, 13, 14, 6, 10, 7, 8, 11, 12, 15):

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time;
2. kernels: the dominance kernel against its plain PyTorch version on the
   card (exact) over P in {1, 7, 15, 16, 17, 32, 64, 100, 130, 200, 1000,
   4096, 4099, 4104}, M in {1, 2, 3, 4, 8, 9, 32, 33, 64}, f32/bf16/f16 and
   f32 with +-inf, NaN, signed zeros, subnormals and +-3.4e38; by the
   profiled names, M 3 runs the register kernel
   (``dominance_matrix_kernel<3>``), M 9 the shared-memory one (``<0>``)
   and M 33 the chunked one (``dominance_matrix_chunked_kernel``, 32
   objectives at a time); its time at P = 200, 4096 and 4104 beside the
   plain version's and the card's bound, and the shared-memory and chunked
   variants' at P = 4096, M 9, 32, 33, 64;
3. main path: ``repro_torch.quickstart.run_quickstart()`` at full size (500
   requests, pop 100, 60 generations); the dominance kernel must launch
   exactly 61 times (init + 60 generations), the attention kernels never;
   then one population evaluation is profiled (host wall time against the
   card's busy time);
4. device against CPU: the same evaluator on the card and on the CPU must
   route every request identically;
5. large population: a direct-assignment NSGA-II at a combined population
   of 4096 over the same trace, kernel on;
6. attention kernels: the decode and flash kernels against their plain
   versions on the card, f32 (2e-5) and bf16 (2e-2), over ragged shapes,
   kv_len 0 (zeros) and past Smax, the cache past kv_len filled with
   +-999 and NaN (output unchanged); bf16 flash must run the tensor-core
   kernel and f32 flash the CUDA-core one (by the profiled kernel names),
   decode must split every (b, kv head) over several blocks at Smax 512
   and 1,088, and unaligned inputs must raise; then each timed at the
   serving shapes (flash at S 64, 128 and 512) beside its plain version,
   SDPA and its bound;
7. serve: ``repro_torch.serve.run_serve`` answers the trace's first 32
   requests with qwen3-1.7b at its published width and depth (28 layers,
   random weights from a seed) on 8 slots of 512 positions, in chunks of 8
   decode iterations; the decode kernel must launch 28 times per decode
   iteration, the flash kernel 28 times per admission, the dominance
   kernel never; then one decode iteration is profiled (the card's idle
   share, its top device ops and host ops);
8. serve check: every served token is a teacher-forced maximum of
   ``train_logits`` on the card (within 2e-2 of the row's max|logit|), and
   the same engine at full width and 2 layers gives the CPU's greedy
   tokens, except at the CPU's own near-ties;
9. counts kernel: the dominator-counts kernel exactly equal to its plain
   version and to the column sums of the matrix kernel, over P in {1, 63,
   64, 65, 200, 4096, 4099}, M 1-9 and 33, f32/bf16/f16, ties, duplicates
   and NaN rows, and on every objective matrix that phases 3 and 5 sorted;
   timed at P = 200 and 4096;
10. paged kernel: the paged decode kernel against its plain version (2e-5
   f32, 2e-2 bf16) and bit for bit equal to the decode kernel on the
   gathered cache (the same split kernel with other row addresses), in
   the TPU pool layout and the serving store's, block sizes 8 and 16, pad
   entries, negative ids, kv_len 0, NaN in unreferenced blocks (output bit
   for bit unchanged); unaligned pools must raise;
11. serve sessions: the 47 requests of the multi-turn session trace with
   the same model on 8 slots of 1,088 positions, with the paged prefix
   cache (16-token blocks) and without, in turns (on, off, off, on);
   in every run flash launches = 28 per admission, decode launches = 28
   per iteration, paged and counts kernels never; the cache counters, zero leaked blocks, every token a
   teacher-forced maximum, the two runs' tokens parting only at near-ties;
   one decode iteration profiled; the decode kernel timed at that
   iteration's cache fills (Smax 1,088) and the flash kernel's
   prefix-extend variant at the run's median admission;
12. paged on pools: block tables from the served prompts' cached blocks,
   8 rows a batch, the paged kernel held on all 28 layers of the store's
   pools bit for bit against the decode kernel on the gathered cache and
   against the plain version (one row ending mid-block), and timed there
   beside the decode kernel on the gathered cache; by the profiled trace,
   a paged call launches splits x Hkv x B blocks of the split kernel;
13. online: ``repro_torch.online.run_online()`` at the reference's sizes
   (the mix-shift and burst scenarios, 4 open-loop windows of 60 requests
   with SLO deadlines, pop 16 x 10 generations for window 0's tuning and
   every re-fit, QoE objectives); the dominance kernel must launch 11 times
   per evolve (5 a scenario) and run ``dominance_matrix_kernel<4>`` (by
   the profiled name); in every window the card's assignments under the
   static, adaptive and cloud-only policies equal the CPU's exactly, the
   objectives agree within 1e-5, and the re-fit's evaluator padded to 64
   rows gives the 60-row one's rows bit for bit; then one
   ``RequestRouter.maybe_reoptimize`` at the router's defaults (window 256,
   pop 32, 20 generations: 21 launches) on 256 recorded requests of the
   burst phase, one population evaluation of its 256-row table profiled,
   and the kernel timed at the re-fit's P = 32 and 64, M = 4; last, every
   objective matrix that these sorts saw (131) goes through the matrix and
   counts kernels again, each exactly equal to its plain version;
14. policy matrix: ``repro_torch.policy_matrix.run()`` at the reference's
   full size (192 session requests with SLO deadlines, the prefix cache
   on, pop 16 x 12 generations a policy, QoE objectives): a tuned row for
   every registered policy; the dominance kernel must launch 13 times a
   fit (117 for the nine policies) and run ``dominance_matrix_kernel<4>``;
   every row's genome, replayed on the card in the three configurations
   of its decision space (clean, straggler on static priors, straggler
   with the learned estimators), equals a CPU evaluator's assignments
   exactly, with rows and QoE objectives within 1e-6; one population
   evaluation profiled per configuration (six); ``route()`` timed for
   every runtime policy, static and learned; the learned ``affinity`` and
   ``disagg`` routers driven over the trace with ``record(ttft=, tpot=)``
   (decisions and estimator state equal to a CPU router's), then one
   ``maybe_reoptimize`` each at the router's defaults (21 launches each);
   last, both dominance kernels exactly equal to their plain versions on
   all 159 matrices those sorts saw;
15. cluster: the serving launcher (``repro_torch.launch.serve.run_launch``)
   at the published widths, stablelm-3b for the cloud pair and one
   qwen3-1.7b shared by the 9 edge pairs (2 cohorts: 1 and 9 members),
   random bf16 weights from seeds 0 and 1, engines of 8 slots x 128
   positions. Run A: NSGA-II tunes the thresholds (pop 48 x 30 generations
   on the 64-request trace), then the trace's 64 requests are served in
   ticks of 8 decode iterations, node 1 failing after the 6th submission
   (the tuned router sends every request to the cloud, so node 1 holds no
   flight then and only hedges reach the edge). Run B: the same with the
   paper's default thresholds, under which node 1 holds live flights when
   it fails; at least one is cancelled and re-routed. Asserted for each:
   every request done with its budget of tokens; each node's dispatches
   closed as completed, failed or cancelled, queues drained; no block
   leaked (vacuous: these engines keep no prefix cache); an engine's own
   tokens (its count less its cohort's) only from decodes of its own;
   node 1 the only node down, no request served there, its failures equal
   to the reroutes; every token a teacher-forced maximum; launches exactly
   31 dominance in A (1 + generations) and none in B, flash n_layers per
   admission, decode n_layers per cohort iteration (one launch a layer for
   all of a cohort's rows) plus per engine-own iteration, paged and counts
   never. Then a saturated tick (every slot busy) timed fleet against the
   per-engine loop in turns, the two servers' tokens compared slot by slot
   (parting only at near-ties, reported), one fleet tick profiled (the
   card's idle share), the decode kernel timed at the cohort's 72 rows and
   the cloud's 8 beside SDPA and the bound; last the launcher's run at
   full width and 2 layers a model, fleet on and off, under the tuned and
   the default thresholds: the same routing decisions (audit records),
   QoE records and token counts, node 1 the only node down, tokens parting
   only at near-ties (counted and reported).

Phase 6 also holds the flash kernel's prefix-extend variant against its
plain version (bucketed and exact-length, garbage and NaN past prefix_len).
Then the ``{"kernels": [...]}`` line (all five kernels) and, last, the
``{"ok": true, ...}`` line. Any failure raises and exits non-zero. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing anything.
"""
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DEC_HEADS = ((16, 8, 128), (32, 32, 80), (8, 1, 64))   # (Hq, Hkv, D)
# 1,088 is the session engine's Smax: 9 splits of 128 positions
DEC_SMAX = (64, 512, 520, 1088)
FA_S = (1, 17, 64, 128, 192, 200, 512)
SERVE_MODEL, SERVE_REQUESTS = "qwen3-1.7b", 32
CHECK_LAYERS, CHECK_REQUESTS = 2, 8
DOM_CASES_P = (1, 7, 15, 16, 17, 32, 64, 100, 130, 200, 1000, 4096, 4099,
               4104)
DOM_CASES_M = (1, 2, 3, 4, 8, 9, 32, 33, 64)
# the split decode kernel's two instantiations, by their profiled names
DECODE_KERNEL = "ContiguousRows"
PAGED_KERNEL = "PagedRows"
COUNT_CASES_P = (1, 63, 64, 65, 200, 4096, 4099)
COUNT_CASES_M = tuple(range(1, 10)) + (33,)
# (B, Hq, Hkv, n_blocks, block_size, max_blocks, D): tests/test_kernels.py's
# shapes, and the serving heads at block sizes 8 and 16
PAGED_CASES = ((1, 8, 8, 16, 16, 4, 64), (2, 8, 2, 24, 16, 4, 64),
               (3, 4, 1, 12, 8, 6, 32), (8, 16, 8, 96, 8, 40, 128),
               (8, 16, 8, 96, 16, 24, 128))
# (S_pre, Sq, prefix_len): prefix_len None is the exact-length extend
EXT_CASES = ((16, 8, None), (200, 1, None), (64, 17, 40), (32, 33, 0),
             (1088, 64, 16), (1088, 64, 512), (1088, 128, 960))
QUICKSTART = dict(n_requests=500, pop_size=100, n_generations=60)
LARGE_POP, LARGE_GENS = 2048, 5
# the router's own re-fit defaults, on a window of the burst phase
REFIT_REQUESTS, REFIT_POP, REFIT_GENS = 256, 32, 20
# the serving launcher's runs: 64 requests, 30 generations of tuning, node 1
# failed after the 6th submission
CLUSTER_REQUESTS, CLUSTER_GENS, CLUSTER_FAIL = 64, 30, (1, 5)


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


def _device_events(fn, *args, iters=20):
    """(name, µs) of every device kernel that ``iters`` calls of ``fn`` run
    after a warm-up call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
            if ev.device_type.name == "CUDA"]


def device_kernel_ms(fn, *args, name="dominance_matrix", iters=20,
                     attempts=3):
    """Median device time of the named kernel from torch.profiler, or None
    when the profiler records no device activity (a window without any is
    profiled again, up to ``attempts`` times)."""
    for _ in range(attempts):
        us = [t for n, t in _device_events(fn, *args, iters=iters)
              if name in n]
        if us:
            return statistics.median(us) / 1e3
    return None


def device_total_ms(fn, *args, iters=20):
    """Device time of one call of ``fn``, all its kernels together (the
    mean over ``iters`` calls), or None when the profiler records no device
    activity."""
    us = [t for _, t in _device_events(fn, *args, iters=iters)]
    return sum(us) / iters / 1e3 if us else None


def device_kernel_names(fn, *args, iters=5, attempts=3):
    """The names of the device kernels that calls of ``fn`` run (the
    profiler now and then records no device activity for a window: then
    the window is profiled again)."""
    for _ in range(attempts):
        names = sorted({n for n, _ in _device_events(fn, *args, iters=iters)})
        if names:
            return names
    return []


def device_kernel_grids(fn, *args, name, iters=3, attempts=8):
    """(grids, windows): the grids (blocks along x, y, z) of the device
    kernels whose name holds ``name`` over ``iters`` calls of ``fn``, from
    the profiler's Chrome trace (written under build/, read and removed),
    and, for each profiled window, the trace's kernel events and the
    profiler's own device events (``prof.events()``) whose name holds
    ``name``. A window whose trace holds no such kernel is profiled again
    after a pause that doubles from 0.5 s to 4 s, up to ``attempts`` times
    (the profiler now and then records nothing for a window, and once for
    eight windows 0.5 s apart); the windows are reported so that a
    recurring dropout, or a kernel that really goes missing, shows (and
    which of the two records lost it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(exist_ok=True)
    fn(*args)
    torch.cuda.synchronize()
    windows = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        kernels = [e for e in events if e.get("cat") == "kernel"]
        grids = [tuple(e["args"]["grid"]) for e in kernels
                 if name in e.get("name", "") and "grid" in e.get("args", {})]
        windows.append({"trace_kernels": len(kernels),
                        "trace_named": len(grids),
                        "profiler_named": sum(
                            1 for ev in prof.events()
                            if ev.device_type.name == "CUDA"
                            and name in ev.name)})
        if grids:
            return grids, windows
        time.sleep(min(0.5 * 2 ** (len(windows) - 1), 4.0))
    return [], windows


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


def _dominance_special(P, M, gen):
    """f32 objectives where the kernel's subtraction path could go wrong
    and where it must step aside: +-inf, NaN, signed zeros, subnormals and
    the largest finite values (their differences overflow)."""
    import torch
    F = torch.round(torch.rand((P, M), generator=gen) * 8) / 8 - 0.5
    big = torch.finfo(torch.float32).max
    edge = [float("inf"), float("-inf"), float("nan"), -0.0, 0.0, 1e-45,
            -1e-45, big, -big]
    for r in range(min(P, 3 * len(edge))):
        F[r, r % M] = edge[r % len(edge)]
    if P > 1:
        F[P - 1] = F[0]
    return F.cuda()


def phase_kernels():
    import torch
    from repro_torch.kernels import dominance, ops, ref
    gen = torch.Generator().manual_seed(0)
    n_cases = n_exact = 0
    max_err = 0
    for P in DOM_CASES_P:
        for M in DOM_CASES_M:
            for dtype in (torch.float32, torch.bfloat16, torch.float16,
                          "special"):
                F = (_dominance_special(P, M, gen) if dtype == "special"
                     else _dominance_input(P, M, dtype, gen))
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
    # M <= 8 keeps the column objectives in registers (a kernel per M), M
    # up to 32 in shared memory (<0>), a larger M 32 objectives at a time
    names = {}
    for M, want in ((3, "dominance_matrix_kernel<3>"),
                    (9, "dominance_matrix_kernel<0>"),
                    (33, "dominance_matrix_chunked_kernel")):
        F = torch.rand((4096, M), device="cuda")
        got = {_kernel_name(n) for n in device_kernel_names(
            ops.dominance_matrix, F) if "dominance_matrix" in n}
        assert got == {want}, (M, got)
        names[f"M{M}"] = want
    timing = {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for P in (200, 4096, 4104):
        F = torch.rand((P, 3), device="cuda")
        timing[P] = dict(
            ms=time_ms(ops.dominance_matrix, F),
            plain_ms=time_ms(ref.dominance_matrix, F),
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(P, 3),
            grid=list(dominance.dominance_grid(P, n_sm)))
    # at P = 4096 the shared-memory variant (M 9, 32) and the chunked one
    # (two chunks of objectives: M 33, 64)
    any_m = {}
    for M in (9, 32, 33, 64):
        F = torch.rand((4096, M), device="cuda")
        ops_bound = (2 * 4096 * 4096 * M / F32_OPS_PER_S * 1e3
                     >= dominance_bound_ms(4096, M))
        any_m[f"m{M}"] = dict(
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(4096, M),
            bound_by="operations" if ops_bound else "bytes")
    row = {"phase": "kernels", "name": "dominance_matrix", "cases": n_cases,
           "exact": n_exact == n_cases, "max_abs_err": max_err,
           "kernel_names": names,
           "timing": {str(P): t for P, t in timing.items()},
           "timing_p4096_shared": any_m}
    emit(row)
    return row


def zero_launches():
    from repro_torch.kernels import (decode_attention, dominance,
                                     flash_attention, paged_attention)
    dominance.LAUNCHES = dominance.COUNTS_LAUNCHES = 0
    flash_attention.LAUNCHES = decode_attention.LAUNCHES = 0
    paged_attention.LAUNCHES = 0


def launch_counts(**expected):
    """Every kernel's launch count since ``zero_launches``; a kernel not
    named in ``expected`` must not have launched."""
    from repro_torch.kernels import (decode_attention, dominance,
                                     flash_attention, paged_attention)
    got = {"dominance_matrix": dominance.LAUNCHES,
           "dominance_counts": dominance.COUNTS_LAUNCHES,
           "flash_attention": flash_attention.LAUNCHES,
           "gqa_decode_attention": decode_attention.LAUNCHES,
           "paged_gqa_decode_attention": paged_attention.LAUNCHES}
    want = {k: expected.get(k, 0) for k in got}
    assert got == want, f"launches {got}, want {want}"
    return got


class SortedObjectives:
    """Keeps a copy of every objective matrix the NSGA-II sort hands to the
    dominance kernel while it is entered (the counts phase holds the counts
    kernel on them); the sort itself runs unchanged."""

    def __init__(self):
        self.Fs = []

    def __enter__(self):
        from repro_torch.core import pareto
        self._orig = orig = pareto.dominance_matrix

        def record(F):
            self.Fs.append(F.detach().clone())
            return orig(F)

        pareto.dominance_matrix = record
        return self

    def __exit__(self, *exc):
        from repro_torch.core import pareto
        pareto.dominance_matrix = self._orig


def phase_main_path(sorted_F):
    import numpy as np
    from repro_torch.quickstart import format_table, run_quickstart
    zero_launches()
    t0 = time.perf_counter()
    with sorted_F:
        res = run_quickstart(**QUICKSTART)
    wall = time.perf_counter() - t0
    launches = launch_counts(
        dominance_matrix=1 + QUICKSTART["n_generations"])["dominance_matrix"]
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


def profile_fitness(fit, genomes, n_requests):
    """Host wall time of one population evaluation against the card's busy
    time in it (torch.profiler), its device events and top device ops."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    return {"what": f"one fitness call, pop {genomes.shape[0]} x "
            f"{n_requests} requests", "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "device_events": n_events,
            "us_per_request_step": wall / n_requests * 1e6,
            "top_device_us": by_name.most_common(6)}


def phase_profile(genomes):
    """Where one population evaluation of the main path spends its time:
    host wall time against the card's busy time (torch.profiler)."""
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.workload.trace import build_trace
    ev = TraceEvaluator(build_trace(500, seed=0), paper_testbed(),
                        EvalConfig(concurrency=1), device="cuda")
    emit({"phase": "profile",
          **profile_fitness(ev.make_fitness("threshold"), genomes, 500)})


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


def phase_large_population(sorted_F):
    import torch
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.baselines import heuristic_bias_init
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.nsga2 import NSGA2, NSGA2Config
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

    zero_launches()
    tick()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with sorted_F:
        state = opt.evolve(gen, LARGE_GENS, callback=tick)
    launches = launch_counts(dominance_matrix=1 + LARGE_GENS)[
        "dominance_matrix"]
    assert state.genomes.shape == (LARGE_POP, trace.n_requests)
    assert bool(torch.isfinite(state.F_raw).all())
    per_gen = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    emit({"phase": "large_population", "pop": LARGE_POP,
          "combined": 2 * LARGE_POP, "generations": LARGE_GENS,
          "launches": launches, "init_plus_first_gen_s": stamps[1] - stamps[0],
          "gen_s": per_gen, "median_gen_s": statistics.median(per_gen),
          "front0": int((state.rank == 0).sum())})
    return launches


def counts_bound(P, M):
    """Least time for the counts: F read once (P*M*4 bytes), the counts
    written once (P*4), 2*P*P*M f32 comparisons; and which bounds it."""
    t_bytes = (P * M * 4 + P * 4) / HBM_BYTES_PER_S
    t_ops = 2 * P * P * M / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_counts(F):
    """The counts kernel on F exactly equal to its plain version and to the
    column sums of the matrix kernel; returns the largest difference."""
    import torch
    from repro_torch.kernels import ops, ref
    got = ops.dominance_counts(F)
    torch.cuda.synchronize()
    want = ref.dominance_counts(F)
    cols = ops.dominance_matrix(F).sum(dim=0, dtype=torch.int32)
    assert got.dtype == torch.int32 and got.shape == (F.shape[0],)
    err = int((got - want).abs().max())
    assert torch.equal(got, want), ("counts != plain", tuple(F.shape),
                                    F.dtype, err)
    assert torch.equal(got, cols), ("counts != matrix columns",
                                    tuple(F.shape), F.dtype)
    return err


def _check_sorted(Fs):
    """Every recorded objective matrix through both dominance kernels, each
    exactly equal to its plain version; returns how many were checked."""
    import torch
    from repro_torch.kernels import ops, ref
    for F in Fs:
        got = ops.dominance_matrix(F)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.dominance_matrix(F)), (
            "matrix != plain", tuple(F.shape))
        _check_counts(F)
    return len(Fs)


def phase_counts_kernel(sorted_F):
    """The dominator-counts kernel exactly equal to its plain version and to
    the column sums of the matrix kernel: synthetic cases, then every
    objective matrix the quickstart's and the pop-4096 run's sorts saw."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(5)
    check = _check_counts
    n = max_err = 0
    for P in COUNT_CASES_P:
        for M in COUNT_CASES_M:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                max_err = max(max_err, check(_dominance_input(P, M, dtype,
                                                              gen)))
                n += 1
    shapes = Counter()
    for F in sorted_F.Fs:
        max_err = max(max_err, check(F))
        shapes[str(tuple(F.shape))] += 1
    assert shapes, "the main path sorted no population"
    timing = {}
    for P in (200, 4096):
        F = torch.rand((P, 3), device="cuda")
        bound, by = counts_bound(P, 3)
        timing[str(P)] = dict(
            ms=time_ms(ops.dominance_counts, F),
            plain_ms=time_ms(ref.dominance_counts, F),
            device_ms=device_kernel_ms(ops.dominance_counts, F,
                                       name="dominance_counts_kernel"),
            bound_ms=bound, bound_by=by, library_ms=None)
    row = {"phase": "counts_kernel", "cases": n,
           "main_path_matrices": len(sorted_F.Fs),
           "main_path_shapes": dict(shapes), "exact": True,
           "max_abs_err": max_err, "timing": timing,
           "library": "none: no single PyTorch call counts dominators"}
    emit(row)
    return row


def _online_window_checks(res, cluster):
    """One scenario's windows against the CPU: the card's per-request rows
    under the static, adaptive and cloud-only policies (assignments exact,
    rows and QoE objectives within 1e-5), and the re-fit's evaluator padded
    to 64 rows against the 60-row one on the card (rows bit for bit)."""
    import numpy as np
    import torch
    from repro_torch import online
    from repro_torch.core import baselines
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    mism = padded_equal = 0
    rel = obj_rel = 0.0
    cfg = EvalConfig(mode="open")
    for w in res.windows:
        cpu = TraceEvaluator(w.trace, cluster, cfg, device="cpu")
        want = {s: cpu.run_thresholds(w.genomes[s])
                for s in ("static", "adaptive")}
        want["cloud_only"] = cpu.run_assignment(
            baselines.cloud_only(w.trace, cluster))
        for s in online.STRATEGIES:
            a, b = w.results[s], want[s]
            mism += int((a.assign.cpu() != b.assign).sum())
            for f in ("q", "cost", "rt", "ttft", "tpot"):
                x, y = getattr(a, f).cpu(), getattr(b, f)
                assert torch.allclose(x, y, rtol=1e-5, atol=1e-6), (s, f)
                rel = max(rel, float(((x - y).abs()
                                      / y.abs().clamp(min=1e-12)).max()))
        G = torch.as_tensor(np.stack([w.genomes["static"],
                                      w.genomes["adaptive"]]))
        dev = TraceEvaluator(w.trace, cluster, cfg, device="cuda")
        Fd, _ = dev.make_fitness("threshold", "qoe")(G)
        Fc, _ = cpu.make_fitness("threshold", "qoe")(G)
        assert torch.allclose(Fd.cpu(), Fc, rtol=1e-5, atol=1e-7), (Fd, Fc)
        obj_rel = max(obj_rel, float(((Fd.cpu() - Fc).abs()
                                      / Fc.abs().clamp(min=1e-12)).max()))
        plain = TraceEvaluator(w.refit_trace, cluster, cfg, device="cuda")
        padded = TraceEvaluator(w.refit_trace, cluster, cfg, bucket="pow2",
                                device="cuda")
        assert (plain.n_padded, padded.n_padded) == (60, 64)
        a = plain.run_population("threshold", G)
        b = padded.run_population("threshold", G)
        for f in ("q", "cost", "rt", "assign", "ttft", "tpot"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        padded_equal += 1
    assert mism == 0, f"{mism} device/CPU assignment mismatches"
    return {"windows": len(res.windows), "assign_mismatches": mism,
            "max_rel_err_rows": rel, "max_rel_err_objectives": obj_rel,
            "padded_64_equal_to_60_windows": padded_equal}


def phase_online():
    """The runtime router's rolling-horizon loop on the card: run_online()
    as a user calls it, then one re-fit at the router's defaults."""
    import numpy as np
    import torch
    from repro_torch import online
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import EvalConfig, TraceEvaluator
    from repro_torch.core.router import RequestRouter
    from repro_torch.kernels import ops, ref
    from repro_torch.workload.arrivals import build_open_loop_trace
    from repro_torch.workload.slo import attach_slos
    cluster = paper_testbed()
    per_evolve = 1 + online.GENS          # the init sort + one a generation
    per_scenario = per_evolve * (1 + online.N_WINDOWS)
    sorted_F = SortedObjectives()
    zero_launches()
    t0 = time.perf_counter()
    with sorted_F:
        results = online.run_online()
    wall = time.perf_counter() - t0
    launches = launch_counts(dominance_matrix=per_scenario * len(results))[
        "dominance_matrix"]
    # the scenarios run in turn, each sorting per_scenario matrices
    assert len(sorted_F.Fs) == launches, (len(sorted_F.Fs), launches)
    row = {"phase": "online", "wall_s": wall, "launches": launches,
           "scenarios": {}}
    for turn, (name, res) in enumerate(results.items()):
        f0, f1 = turn * per_scenario, (turn + 1) * per_scenario
        n = f1 - f0
        shapes = Counter(str(tuple(F.shape)) for F in sorted_F.Fs[f0:f1])
        assert shapes == {f"({online.POP}, 4)": 1 + online.N_WINDOWS,
                          f"({2 * online.POP}, 4)":
                              online.GENS * (1 + online.N_WINDOWS)}, shapes
        F32 = sorted_F.Fs[f1 - 1]
        names = {_kernel_name(k) for k in device_kernel_names(
            ops.dominance_matrix, F32) if "dominance_matrix" in k}
        assert names == {"dominance_matrix_kernel<4>"}, names
        a, st = res.summary["adaptive"], res.summary["static"]
        row["scenarios"][name] = {
            "post_drift": {s: dict(quality=v.quality, cost=v.cost,
                                   attainment=v.attainment, rt=v.rt)
                           for s, v in res.summary.items()},
            "composite": res.composite,
            "adaptive_beats_static": (res.composite["adaptive"]
                                      > res.composite["static"]
                                      and a.attainment >= st.attainment),
            "tune_window0_s": res.tune_s,
            "refit_s": [w.refit_s for w in res.windows],
            "launches": n, "sorted_shapes": dict(shapes),
            "kernel": sorted(names),
            "checks": _online_window_checks(res, cluster)}
        for r in res.rows:
            print(",".join(str(x) for x in r), flush=True)

    # one re-fit at the router's defaults on 256 requests of the burst phase
    burst = online.SCENARIOS["burst"][1]
    tr = attach_slos(build_open_loop_trace(REFIT_REQUESTS, (burst,), seed=7),
                     seed=7)
    router = RequestRouter(cluster, results["burst"].windows[-1]
                           .genomes["adaptive"], device="cuda")
    ev = TraceEvaluator(tr, cluster, EvalConfig(mode="open"), device="cuda")
    online._record_window(router, tr, ev.run_thresholds(router.thresholds))
    refit_F = SortedObjectives()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with refit_F:
        genome = router.maybe_reoptimize(
            force=True, window=REFIT_REQUESTS, generations=REFIT_GENS,
            pop_size=REFIT_POP, weights=online.WEIGHTS)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    refit_launches = launch_counts(dominance_matrix=1 + REFIT_GENS)[
        "dominance_matrix"]
    assert genome is not None and np.isfinite(genome).all()
    window = TraceEvaluator(router.window_trace(REFIT_REQUESTS), cluster,
                            EvalConfig(mode="open"), bucket="pow2",
                            device="cuda")
    assert window.n_padded == REFIT_REQUESTS
    prof = profile_fitness(window.make_fitness("threshold", "qoe"),
                           torch.as_tensor(router._archive, device="cuda"),
                           REFIT_REQUESTS)
    timing = {}
    for P, F in ((2 * online.POP, sorted_F.Fs[-1]),
                 (2 * REFIT_POP, refit_F.Fs[-1])):
        assert tuple(F.shape) == (P, 4), F.shape
        timing[f"p{P}_m4"] = dict(
            ms=time_ms(ops.dominance_matrix, F),
            plain_ms=time_ms(ref.dominance_matrix, F),
            device_ms=device_kernel_ms(ops.dominance_matrix, F),
            bound_ms=dominance_bound_ms(P, 4), bound_by="bytes",
            library_ms=None)
    # every matrix the online sorts saw, through both kernels again
    assert len(refit_F.Fs) == refit_launches, (len(refit_F.Fs),
                                               refit_launches)
    row["matrices_checked"] = _check_sorted(sorted_F.Fs + refit_F.Fs)
    row["refit_256"] = {"requests": REFIT_REQUESTS, "pop": REFIT_POP,
                        "generations": REFIT_GENS, "wall_s": refit_s,
                        "launches": refit_launches, "genome":
                            [float(x) for x in genome],
                        "profile": prof}
    row["timing"] = timing
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the policy matrix: every registered policy, every evaluator mode
# ---------------------------------------------------------------------------

def _qoe_objectives(ev, res):
    """(P, 4) QoE objectives of (P, n_valid) results, by the evaluator's own
    masked-mean arithmetic over the real requests, on the results'
    device."""
    import types
    from repro_torch.core import fitness
    t, n, dev = ev.tables, ev.n_valid, res.q.device
    view = types.SimpleNamespace(valid=t.valid[:n].to(dev),
                                 ttft_deadline=t.ttft_deadline[:n].to(dev),
                                 tpot_deadline=t.tpot_deadline[:n].to(dev))
    return fitness._objectives(res, view, "qoe")


def _matrix_replays(rows, trace, cluster):
    """Every row's genome (default and tuned) on a CPU evaluator of each
    configuration of its decision space, a policy's rows as one
    population, against the card's results behind the rows: assignments
    exact, per-request rows and QoE objectives within 1e-6 (relative past
    1)."""
    import numpy as np
    import torch
    from repro_torch import policy_matrix as pm
    cpu = pm.evaluators(trace, cluster, "cpu")
    mism = replays = 0
    row_rel = obj_rel = 0.0
    configs = set()
    rel = lambda x, y: float(((x - y).abs()  # noqa: E731
                              / y.abs().clamp(min=1.0)).max())
    for policy in dict.fromkeys(r.policy for r in rows):
        mine = [r for r in rows if r.policy == policy]
        space = pm.space_of(policy)
        G = np.stack([r.genome for r in mine])
        for regime in pm.REGIMES:
            ev = cpu[space, regime]
            b = ev.run_population(policy, G)
            for k, r in enumerate(mine):
                a, bk = r.results[regime], type(b)(*(t[k:k + 1]
                                                     for t in b))
                mism += int((a.assign.cpu() != bk.assign).sum())
                for f in ("q", "cost", "rt", "ttft", "tpot", "hit",
                          "transfer"):
                    x, y = getattr(a, f).cpu(), getattr(bk, f)
                    assert torch.allclose(x, y, rtol=1e-6, atol=1e-6), (
                        policy, regime, f, rel(x, y))
                    row_rel = max(row_rel, rel(x, y))
                Fd = _qoe_objectives(ev, a).cpu()
                Fc = _qoe_objectives(ev, bk)
                assert torch.allclose(Fd, Fc, rtol=1e-6, atol=1e-6), (Fd, Fc)
                obj_rel = max(obj_rel, rel(Fd, Fc))
                replays += 1
            configs.add((space, regime))
    assert mism == 0, f"{mism} card/CPU assignment mismatches"
    assert len(configs) == 6, configs
    return {"replays": replays, "configurations": len(configs),
            "assign_mismatches": mism, "max_rel_err_rows": row_rel,
            "max_rel_err_objectives": obj_rel}


def _drive_router(router, trace, block=16):
    """Route the matrix trace through ``router`` as a serving loop would:
    dispatch, the served prefix recorded on the serving node(s), a
    completion four requests later, and ``record`` with realized TTFT and
    TPOT (the cloud node three times slower than the tables). Returns the
    decisions and the host microseconds per ``route()`` call."""
    mon = router.monitor
    decisions, inflight, route_s = [], [], 0.0
    for i, req in enumerate(trace.requests):
        now = float(trace.arrival_time[i])
        dl = dict(ttft_deadline=float(trace.ttft_deadline[i]),
                  tpot_deadline=float(trace.tpot_deadline[i]))
        t0 = time.perf_counter()
        d = router.route(req, now=now, **dl)
        route_s += time.perf_counter() - t0
        mon.on_dispatch(d.node)
        legs = {d.node} if d.prefill_pair is None else {
            d.node, int(router.arrays.pair_node[d.prefill_pair])}
        for node in sorted(legs):
            if req.session_id >= 0:
                mon.record_prefix(node, ("sess", req.session_id),
                                  req.prompt_tokens // block * block)
            if req.sys_id >= 0:
                mon.record_prefix(node, ("sys", req.sys_id),
                                  req.sys_tokens // block * block)
        inflight.append(d.node)
        if len(inflight) > 4:
            mon.on_complete(inflight.pop(0), 1.0)
        slow = 3.0 if d.node == 0 else 1.0
        router.record(req, d, quality=0.5, cost=d.est_cost, rt=1.0, now=now,
                      ttft=d.est_ttft * slow, tpot=d.est_tpot * slow, **dl)
        decisions.append(d)
    return decisions, route_s / len(trace.requests) * 1e6


def phase_policy_matrix():
    """The whole routing-policy registry on the policy-matrix path, on the
    card: ``policy_matrix.run()`` as a user calls it, its rows replayed on
    the CPU, one population evaluation profiled per evaluator
    configuration, ``route()`` timed for every runtime policy, and the
    learned affinity and disagg routers driven and re-fit on the card."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch import policy_matrix as pm
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.policies import (get_policy, list_policies,
                                           runtime_policies)
    from repro_torch.core.router import RequestRouter
    from repro_torch.kernels import ops
    n_pol = len(list_policies())
    per_fit = 1 + pm.GENS               # the init sort + one a generation
    sorted_F = SortedObjectives()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sorted_F:
        rows = pm.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(dominance_matrix=per_fit * n_pol)[
        "dominance_matrix"]
    assert len(sorted_F.Fs) == launches, (len(sorted_F.Fs), launches)
    shapes = Counter(str(tuple(F.shape)) for F in sorted_F.Fs)
    assert shapes == {f"({pm.POP}, 4)": n_pol,
                      f"({2 * pm.POP}, 4)": pm.GENS * n_pol}, shapes
    names = {_kernel_name(k) for k in device_kernel_names(
        ops.dominance_matrix, sorted_F.Fs[-1]) if "dominance_matrix" in k}
    assert names == {"dominance_matrix_kernel<4>"}, names
    tuned = {r.policy for r in rows if r.variant == "tuned"}
    assert tuned == set(list_policies()), tuned
    for r in rows:
        assert all(math.isfinite(c) for c in r.cells()[2:]), r
    cluster = paper_testbed()
    trace = pm.workload(pm.N_REQUESTS)
    parts = {"matrix_s": wall}
    t0 = time.perf_counter()
    checks = _matrix_replays(rows, trace, cluster)
    parts["cpu_replays_s"] = time.perf_counter() - t0

    # one population evaluation per evaluator configuration, profiled
    t0 = time.perf_counter()
    evs = pm.evaluators(trace, cluster, "cuda")
    gen = torch.Generator().manual_seed(3)
    profiles = {}
    for (space, regime), ev in evs.items():
        policy = "disagg" if space == "route" else "affinity"
        spec = get_policy(policy).genome_spec
        lo, hi = (torch.as_tensor(b) for b in (spec.lo, spec.hi))
        G = (lo + torch.rand((pm.POP, len(lo)), generator=gen) * (hi - lo))
        profiles[f"{space}/{regime}"] = {"policy": policy, **profile_fitness(
            ev.make_fitness(policy, "qoe"), G.cuda(), trace.n_requests)}

    parts["profiles_s"] = time.perf_counter() - t0

    # route() on the host, every runtime policy, static and learned
    t0 = time.perf_counter()
    route_us = {}
    for mode in runtime_policies():
        for learned in (False, True):
            router = RequestRouter(cluster, mode=mode, learned=learned,
                                   device="cuda")
            _, us = _drive_router(router, trace)
            route_us[f"{mode}{'/learned' if learned else ''}"] = us

    parts["routers_s"] = time.perf_counter() - t0

    # the learned affinity and disagg routers on the card: decisions equal
    # a CPU router's, then one re-fit each at the router's defaults
    t0 = time.perf_counter()
    refits, refit_Fs = {}, []
    for mode in ("affinity", "disagg"):
        card = RequestRouter(cluster, mode=mode, learned=True, device="cuda")
        host = RequestRouter(cluster, mode=mode, learned=True, device="cpu")
        got, _ = _drive_router(card, trace)
        want, _ = _drive_router(host, trace)
        assert [dc.astuple(d) for d in got] == [dc.astuple(d) for d in want]
        assert (card.monitor.estimator.state.tobytes()
                == host.monitor.estimator.state.tobytes())
        refit_F = SortedObjectives()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with refit_F:
            genome = card.maybe_reoptimize(force=True)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        n = launch_counts(dominance_matrix=1 + REFIT_GENS)[
            "dominance_matrix"]
        assert genome is not None and np.isfinite(genome).all()
        assert len(refit_F.Fs) == n
        refit_Fs += refit_F.Fs
        refits[mode] = {"window": trace.n_requests, "padded_to": 256,
                        "pop": REFIT_POP, "generations": REFIT_GENS,
                        "wall_s": refit_s, "launches": n,
                        "decisions_equal_cpu": len(got),
                        "genome": [float(x) for x in genome]}
    parts["learned_routers_and_refits_s"] = time.perf_counter() - t0
    # every matrix the matrix's fits and the re-fits sorted, through both
    # dominance kernels again, each exactly equal to its plain version
    t0 = time.perf_counter()
    matrices = _check_sorted(sorted_F.Fs + refit_Fs)
    parts["matrix_checks_s"] = time.perf_counter() - t0

    row = {"phase": "policy_matrix", "wall_s": wall,
           "requests": trace.n_requests, "pop": pm.POP,
           "generations": pm.GENS, "policies": n_pol, "launches": launches,
           "sorted_shapes": dict(shapes), "kernel": sorted(names),
           "matrices_checked": matrices,
           "fit_s": {r.policy: r.nsga2_fit_s for r in rows
                     if r.variant == "tuned"},
           "rows": {f"{r.policy}.{r.variant}": dict(zip(
               pm.COLUMNS[2:], r.cells()[2:])) for r in rows},
           "checks": checks, "profiles": profiles,
           "route_us_per_decision": route_us, "refits": refits,
           "parts_s": parts}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def _err(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def _check_close(name, got, want, dtype, case):
    import torch
    tol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape, case
    assert torch.isfinite(got).all(), (name, case)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    assert ok, f"{name} {case}: max abs err {_err(got, want)}"
    return _err(got, want)


def _dtypes():
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dec_case(B, Hq, Hkv, D, Smax, lens, dt, gen, engine_layout):
    import torch
    q = torch.randn((B, Hq, D), generator=gen).to(dt).cuda()
    if engine_layout:   # one layer of the engine's (B, Smax, Hkv, D) cache
        k = torch.randn((B, Smax, Hkv, D), generator=gen).to(dt).cuda()
        v = torch.randn((B, Smax, Hkv, D), generator=gen).to(dt).cuda()
        k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    else:
        k = torch.randn((B, Hkv, Smax, D), generator=gen).to(dt).cuda()
        v = torch.randn((B, Hkv, Smax, D), generator=gen).to(dt).cuda()
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda")


def check_decode_kernel():
    """Every decode case against the plain version; kv_len 0 gives zeros;
    garbage past kv_len leaves the output bit for bit unchanged."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(1)
    n = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D in DEC_HEADS:
            for Smax in DEC_SMAX:
                edge = min(32, Smax)
                b8 = [1, edge, edge + 1, Smax, Smax + 25, 0, Smax // 3,
                      Smax - 1]
                runs = [[x] for x in (1, edge, Smax, Smax + 25, 0)] + [b8]
                for lens in runs:
                    for layout in (False, True):
                        q, k, v, kl = _dec_case(len(lens), Hq, Hkv, D, Smax,
                                                lens, dt, gen, layout)
                        case = (dname, Hq, Hkv, D, Smax, lens, layout)
                        got = ops.gqa_decode_attention(q, k, v, kl)
                        torch.cuda.synchronize()
                        want = ref.gqa_decode(q, k, v, kl)
                        errs[dname] = max(errs[dname], _check_close(
                            "decode", got, want, dname, case))
                        for b, x in enumerate(lens):
                            if x <= 0:
                                assert not got[b].any(), ("kv_len 0", case)
                        n += 1
                # the cache past kv_len: +-999, then NaN
                lens = [1, edge, Smax // 2, Smax, 3, edge + 1, 0, 7]
                q, k, v, kl = _dec_case(8, Hq, Hkv, D, Smax, lens, dt, gen,
                                        True)
                clean = ops.gqa_decode_attention(q, k, v, kl)
                for junk in (999.0, float("nan")):
                    k2, v2 = k.clone(), v.clone()
                    for b, x in enumerate(lens):
                        k2[b, :, x:] = junk
                        v2[b, :, x:] = -junk
                    dirty = ops.gqa_decode_attention(q, k2, v2, kl)
                    assert torch.equal(dirty, clean), ("garbage", junk, Hq,
                                                       Smax, dname)
                    n += 1
    return n, errs


def check_flash_kernel():
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(2)
    n = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D in DEC_HEADS:
            for S in FA_S:
                for causal in (True, False):
                    # the model's layout: (B, S, H, D) projections viewed as
                    # (B, H, S, D); B = 2 on one head shape
                    B = 2 if Hq == 16 else 1
                    q, k, v = (torch.randn((B, S, h, D), generator=gen)
                               .to(dt).cuda().transpose(1, 2)
                               for h in (Hq, Hkv, Hkv))
                    got = ops.flash_attention(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    want = ref.mha_prefill(q, k, v, causal=causal)
                    errs[dname] = max(errs[dname], _check_close(
                        "flash", got, want, dname,
                        (dname, Hq, Hkv, D, S, causal)))
                    n += 1
    return n, errs


def _serving_kv_lens(n=8):
    """The fills the serve phase's first 8 slots reach midway through their
    answers: prompt length plus half the budget."""
    from repro_torch.serve import budget, tokenize
    from repro_torch.workload.trace import build_trace
    tr = build_trace(500, seed=0)
    return [len(tokenize(r, 151936)) + budget(tr.resp_tokens_mean[i]) // 2
            for i, r in enumerate(tr.requests[:n])]


def decode_timing(lens, Smax=512, Hq=16, Hkv=8, D=128):
    """The decode kernel at the serve phase's shapes (bf16, one layer of
    the engine's cache read in place) beside its plain version, SDPA with a
    boolean kv_len mask, and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(3)
    B = len(lens)
    q, k, v, kl = _dec_case(B, Hq, Hkv, D, Smax, lens, torch.bfloat16, gen,
                            True)
    mask = (torch.arange(Smax, device="cuda")[None, :]
            < kl.clamp(max=Smax)[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                              enable_gqa=True)

    n_read = sum(min(x, Smax) for x in lens)
    nbytes = 2 * (2 * B * Hq * D + 2 * n_read * Hkv * D) + 4 * B
    ops_n = 4 * n_read * Hq * D
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S)
    out = dict(shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "Smax": Smax,
                      "kv_len": list(lens), "dtype": "bfloat16"},
               ms=time_ms(ops.gqa_decode_attention, q, k, v, kl),
               device_ms=device_kernel_ms(ops.gqa_decode_attention, q, k, v,
                                          kl, name=DECODE_KERNEL),
               plain_ms=time_ms(ref.gqa_decode, q, k, v, kl),
               bound_ms=bound,
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    got = ops.gqa_decode_attention(q, k, v, kl)
    out["max_abs_err"] = _check_close("decode", got, ref.gqa_decode(
        q, k, v, kl), "bfloat16", out["shape"])
    try:
        torch.testing.assert_close(library()[:, :, 0], got, atol=2e-2,
                                   rtol=2e-2)
        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = device_total_ms(library)
    except (TypeError, RuntimeError) as e:   # SDPA without enable_gqa
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def flash_timing(S, causal=True, B=1, Hq=16, Hkv=8, D=128):
    """The flash kernel at a serve phase prefill shape (bf16, the model's
    (B, S, H, D) projections read in place) beside its plain version,
    SDPA and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((B, S, h, D), generator=gen).to(torch.bfloat16)
               .cuda().transpose(1, 2) for h in (Hq, Hkv, Hkv))

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    ops_n = 4 * B * Hq * pairs * D
    out = dict(shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S": S,
                      "causal": causal, "dtype": "bfloat16"},
               ms=time_ms(ops.flash_attention, q, k, v, causal),
               device_ms=device_kernel_ms(ops.flash_attention, q, k, v,
                                          causal,
                                          name="flash_attention_kernel"),
               plain_ms=time_ms(ref.mha_prefill, q, k, v, causal),
               bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops_n / BF16_OPS_PER_S),
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    got = ops.flash_attention(q, k, v, causal)
    out["max_abs_err"] = _check_close("flash", got, ref.mha_prefill(
        q, k, v, causal=causal), "bfloat16", out["shape"])
    try:
        torch.testing.assert_close(library(), got, atol=2e-2, rtol=2e-2)
        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = device_total_ms(library)
    except (TypeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def flash_groups_timing():
    """Device time of the bf16 flash kernel with one and with two
    warpgroups a block, forced, at the serving heads: the evidence for
    ``flash_attention.flash_groups``' choice."""
    import torch
    from repro_torch.kernels import flash_attention, ops
    gen = torch.Generator().manual_seed(11)
    auto = flash_attention.flash_groups
    out = {}
    try:
        for S in (64, 128, 512, 1088):
            q, k, v = (torch.randn((1, S, h, 128), generator=gen)
                       .to(torch.bfloat16).cuda().transpose(1, 2)
                       for h in (16, 8, 8))
            for g in (1, 2):
                flash_attention.flash_groups = lambda *a, g=g: g
                out[f"S{S}_groups{g}_device_ms"] = device_kernel_ms(
                    ops.flash_attention, q, k, v, True,
                    name="flash_attention_kernel")
        q, kp, vp, k, v = _ext_case(1, 16, 8, 128, 1088, 128, torch.bfloat16,
                                    gen)
        for g in (1, 2):
            flash_attention.flash_groups = lambda *a, g=g: g
            out[f"extend_1088_128_224_groups{g}_device_ms"] = \
                device_kernel_ms(ops.flash_attention_extend, q, kp, vp, k,
                                 v, 224, name="flash_attention_kernel")
    finally:
        flash_attention.flash_groups = auto
    return out


def _ext_case(B, Hq, Hkv, D, S_pre, Sq, dt, gen):
    """q, prefix k/v, suffix k/v in the model's layout: (B, S, H, D)
    tensors viewed as (B, H, S, D)."""
    import torch
    return [torch.randn((B, S, h, D), generator=gen).to(dt).cuda()
            .transpose(1, 2)
            for S, h in ((Sq, Hq), (S_pre, Hkv), (S_pre, Hkv), (Sq, Hkv),
                         (Sq, Hkv))]


def check_flash_extend():
    """The prefix-extend variant against its plain version; in the
    bucketed mode, +-999 and NaN in the prefix rows past prefix_len leave
    the output bit for bit unchanged."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(6)
    n = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for Hq, Hkv, D in DEC_HEADS:
            for S_pre, Sq, plen in EXT_CASES:
                B = 2 if Hq == 16 and S_pre < 1000 else 1
                q, kp, vp, k, v = _ext_case(B, Hq, Hkv, D, S_pre, Sq, dt, gen)
                case = (dname, Hq, Hkv, D, S_pre, Sq, plen)
                got = ops.flash_attention_extend(q, kp, vp, k, v, plen)
                torch.cuda.synchronize()
                want = ref.mha_prefill_extend(q, kp, vp, k, v, plen)
                errs[dname] = max(errs[dname], _check_close(
                    "flash_extend", got, want, dname, case))
                n += 1
                if plen is None:
                    continue
                for junk in (999.0, float("nan")):
                    kp2, vp2 = kp.clone(), vp.clone()
                    kp2[:, :, plen:] = junk
                    vp2[:, :, plen:] = -junk
                    dirty = ops.flash_attention_extend(q, kp2, vp2, k, v,
                                                       plen)
                    assert torch.equal(dirty, got), ("garbage", junk, case)
                    n += 1
    return n, errs


def extend_timing(S_pre, Sq, plen, B=1, Hq=16, Hkv=8, D=128):
    """The flash kernel's prefix-extend variant at a session admission's
    shape (bf16, the model's layout read in place) beside its plain
    version, SDPA over the concatenated K/V with the boolean mask, and its
    bound (the prefix rows it must read: plen, not S_pre)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(7)
    q, kp, vp, k, v = _ext_case(B, Hq, Hkv, D, S_pre, Sq, torch.bfloat16,
                                gen)
    kf, vf = torch.cat([kp, k], dim=2), torch.cat([vp, v], dim=2)
    col = torch.arange(S_pre + Sq, device="cuda")[None, :]
    row = torch.arange(Sq, device="cuda")[:, None]
    mask = torch.where(col < S_pre, col < plen, (col - S_pre) <= row)

    def library():
        return F.scaled_dot_product_attention(q, kf, vf, attn_mask=mask,
                                              enable_gqa=True)

    pairs = Sq * plen + Sq * (Sq + 1) // 2
    nbytes = 2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * (plen + Sq) * D)
    ops_n = 4 * B * Hq * pairs * D
    out = dict(shape={"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "S_pre": S_pre,
                      "Sq": Sq, "prefix_len": plen, "dtype": "bfloat16"},
               ms=time_ms(ops.flash_attention_extend, q, kp, vp, k, v, plen),
               device_ms=device_kernel_ms(ops.flash_attention_extend, q, kp,
                                          vp, k, v, plen,
                                          name="flash_attention_kernel"),
               plain_ms=time_ms(ref.mha_prefill_extend, q, kp, vp, k, v,
                                plen),
               bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops_n / BF16_OPS_PER_S),
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    got = ops.flash_attention_extend(q, kp, vp, k, v, plen)
    out["max_abs_err"] = _check_close("flash_extend", got,
                                      ref.mha_prefill_extend(q, kp, vp, k, v,
                                                             plen),
                                      "bfloat16", out["shape"])
    try:
        torch.testing.assert_close(library(), got, atol=2e-2, rtol=2e-2)
        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = device_total_ms(library)
    except (TypeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def _kernel_name(signature):
    """A profiled kernel's name without its namespace and arguments."""
    import re
    return re.search(r"\w+_kernel\w*(<[^>]*>)?", signature).group(0)


def check_kernel_routes():
    """bf16 flash runs the tensor-core (wgmma) kernel and f32 flash the
    CUDA-core one, by the names the profiler records; the decode kernel
    splits every (b, kv head) over several blocks at the serving Smax;
    inputs the 16-byte copies cannot take raise ValueError."""
    import torch
    from repro_torch.kernels import decode_attention, ops
    gen = torch.Generator().manual_seed(10)
    routes = {}
    for dname, dt in _dtypes().items():
        q, k, v = (torch.randn((1, 128, h, 128), generator=gen).to(dt)
                   .cuda().transpose(1, 2) for h in (16, 8, 8))
        every = device_kernel_names(ops.flash_attention, q, k, v, True)
        names = [n for n in every if "flash_attention_kernel" in n]
        want = {"bfloat16": "flash_attention_kernel_wgmma",
                "float32": "flash_attention_kernel<float>"}[dname]
        assert names and all(want in n for n in names), (dname, every)
        routes[dname] = sorted({_kernel_name(n) for n in names})
    # bf16 warpgroups per block, as flash_attention.flash_groups picks them:
    # one for a single key tile (S 64), two from two tiles on (S 128)
    for S, groups in ((64, 1), (128, 2)):
        qs, ks, vs = (torch.randn((1, S, h, 128), generator=gen)
                      .to(torch.bfloat16).cuda().transpose(1, 2)
                      for h in (16, 8, 8))
        got = {_kernel_name(n) for n in device_kernel_names(
            ops.flash_attention, qs, ks, vs, True)
            if "flash_attention_kernel" in n}
        assert got == {f"flash_attention_kernel_wgmma<128, {groups}>"}, got
        routes[f"bfloat16_S{S}"] = sorted(got)
    qd, kd, vd, kl = _dec_case(8, 16, 8, 128, 512, [512] * 8,
                               torch.bfloat16, gen, True)
    dec_names = [n for n in device_kernel_names(ops.gqa_decode_attention,
                                                qd, kd, vd, kl)
                 if "split_decode_kernel" in n and DECODE_KERNEL in n]
    # the split kernel's ticket buffer: an int* (mangled "Pi") parameter
    assert len(dec_names) == 1 and ("int*" in dec_names[0]
                                    or "PfPi" in dec_names[0]), dec_names
    splits = {Smax: decode_attention.decode_split(8, 8, Smax, torch.cuda
                                                  .get_device_properties(0)
                                                  .multi_processor_count)
              for Smax in (512, 1088)}
    assert all(sp > 1 for _, sp in splits.values()), splits

    def unaligned(shape):
        """A view whose row stride is not a multiple of 16 bytes, and one
        2 bytes past an aligned address."""
        n = math.prod(shape)
        odd = torch.zeros(shape[:-1] + (shape[-1] + 4,), dtype=torch.bfloat16,
                          device="cuda")[..., :shape[-1]]
        raw = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")
        return odd, raw[1:1 + n].view(shape)

    def refuses(fn, *args):
        try:
            fn(*args)
        except ValueError:
            return True
        return False

    qb = q.to(torch.bfloat16)
    refused = sum(refuses(ops.gqa_decode_attention, qd, bad, bad, kl)
                  for bad in unaligned((8, 8, 512, 128)))
    refused += sum(refuses(ops.flash_attention, qb, bad, bad, True)
                   for bad in unaligned((1, 8, 128, 128)))
    assert refused == 4, refused
    return {"flash_kernels": routes,
            "decode_kernel": _kernel_name(dec_names[0]),
            "decode_split": {str(k): list(v) for k, v in splits.items()},
            "unaligned_refused": refused}


def phase_attention_kernels():
    n_dec, dec_err = check_decode_kernel()
    n_fa, fa_err = check_flash_kernel()
    n_ext, ext_err = check_flash_extend()
    routes = check_kernel_routes()
    lens = _serving_kv_lens()
    row = {"phase": "attention_kernels", "routes": routes,
           "decode": {"cases": n_dec, "max_abs_err": dec_err,
                      "serving": decode_timing(lens),
                      "full_cache": decode_timing([512] * 8)},
           "flash": {"cases": n_fa, "max_abs_err": fa_err,
                     "serving": flash_timing(128),
                     "s64": flash_timing(64),
                     "s512": flash_timing(512),
                     "groups": flash_groups_timing()},
           "flash_extend": {"cases": n_ext, "max_abs_err": ext_err}}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _profile_step(engine, n_steps=5):
    """Host wall time of one decode iteration (median of ``n_steps``
    unprofiled) and the card's busy time in one profiled iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # the kv_len the decode kernel reads in the profiled iteration
    decode_kv_len = (engine.cache.kv_len + 1).tolist()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name, host = Counter(), Counter()
    n_events = 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by_name[ev.name[:60]] += ev.time_range.elapsed_us()
            n_events += 1
        else:   # where the host's time goes (inflated by the profiler)
            host[ev.name[:60]] += ev.self_cpu_time_total
    busy = sum(by_name.values()) / 1e6
    wall = statistics.median(walls)
    return {"step_wall_s": wall, "profiled_step_wall_s": prof_wall,
            "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_events": n_events, "decode_kv_len": decode_kv_len,
            "top_device_us": by_name.most_common(8),
            "top_host_self_us": host.most_common(8)}


def phase_serve():
    import torch
    from repro_torch import serve
    from repro_torch.configs import get
    cfg = get(SERVE_MODEL).config()
    t0 = time.perf_counter()
    model = serve.build_model(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve.run_serve(cfg=cfg, model=model, n_requests=2, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    run = serve.run_serve(cfg=cfg, model=model, n_requests=SERVE_REQUESTS,
                          device="cuda")
    e = run.engine
    launches = launch_counts(gqa_decode_attention=cfg.n_layers * e._steps,
                             flash_attention=cfg.n_layers * e.admissions)

    assert sorted(run.results) == list(range(SERVE_REQUESTS))
    for rid, r in run.results.items():
        assert len(r["tokens"]) == run.budgets[rid], rid
        assert all(0 <= t < cfg.vocab for t in r["tokens"]), rid
    assert e.admissions == SERVE_REQUESTS
    tokens = sum(len(r["tokens"]) for r in run.results.values())
    print("\n".join(serve.format_run(run)[:4] + ["  ..."]), flush=True)

    # one decode iteration with every slot busy, profiled
    from repro_torch.serving import LLMEngine
    prof_eng = LLMEngine(cfg, model, serve.SERVE_ENGINE, device="cuda")
    tr = serve.build_trace(500, seed=0)
    for rid, req in enumerate(tr.requests[:serve.SERVE_ENGINE.max_slots]):
        prof_eng.submit(rid, serve.tokenize(req, cfg.vocab),
                        max_new_tokens=64)
    prof = _profile_step(prof_eng)
    row = {"phase": "serve", "model": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_counts()["total"],
           "engine": dataclasses.asdict(serve.SERVE_ENGINE),
           "chunk": serve.CHUNK, "requests": SERVE_REQUESTS,
           "launches": launches, "decode_iterations": e._steps,
           "admissions": e.admissions, "tokens": tokens,
           "init_s": init_s, "wall_s": run.wall_s,
           "tokens_per_s": tokens / run.wall_s,
           "prefill_ms_mean": 1e3 * e.prefill_seconds / e.admissions,
           "decode_iteration_ms_mean": 1e3 * e.decode_seconds / e._steps,
           "host_syncs": e.host_syncs,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "qoe": e.qoe_summary(), "decode_iteration_profile": prof}
    emit(row)
    return run, model, row


def _near_tie_ok(logits_row, tok):
    """(ok, gap / max|logit|): the token's logit lies within 2e-2 of the
    row's max|logit| below the row's max."""
    scale = float(logits_row.abs().max())
    gap = float(logits_row.max() - logits_row[tok])
    return gap <= 2e-2 * scale, gap / scale


def phase_serve_check(run, model):
    import torch
    from repro_torch import serve
    from repro_torch.models import lm
    cfg = run.cfg
    n_tok, worst = _teacher_forced(model, cfg, run)

    # the card against the CPU: full width, 2 layers, the same weights
    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    cpu_model = serve.build_model(cfg2, "cpu", seed=1)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    kw = dict(cfg=cfg2, n_requests=CHECK_REQUESTS)
    cpu = serve.run_serve(model=cpu_model, device="cpu", **kw)
    card = serve.run_serve(model=card_model, device="cuda", **kw)
    diverged, differing, ties = 0, 0, []
    for rid, want in cpu.results.items():
        a, b = card.results[rid]["tokens"], want["tokens"]
        differing += sum(x != y for x, y in zip(a, b))
        if a == b:
            continue
        diverged += 1
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = list(cpu.prompts[rid]) + b[:j]
        row = lm.train_logits(cpu_model, cfg2, torch.tensor([seq]))[0, -1]
        top2 = row.topk(2).values
        gap = float(top2[0] - top2[1]) / float(row.abs().max())
        ties.append({"request": rid, "position": j, "cpu_top2_gap": gap})
        assert gap < 2e-2, ("card and CPU differ away from a near-tie", rid,
                            j, gap)
    out = {"phase": "serve_check", "teacher_forced_tokens": n_tok,
           "worst_gap_over_max_logit": worst,
           "card_vs_cpu": {"layers": CHECK_LAYERS, "requests": CHECK_REQUESTS,
                           "tokens": sum(len(r["tokens"])
                                         for r in cpu.results.values()),
                           "diverged_requests": diverged,
                           "differing_tokens": differing,
                           "divergences": ties}}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the paged decode kernel
# ---------------------------------------------------------------------------

def _paged_case(B, Hq, Hkv, nb, bs, mb, D, dt, gen, store_layout):
    """q, pools (the TPU layout (n_blocks, Hkv, bs, D), or the serving
    store's (n_blocks, bs, Hkv, D) permuted to it in place), a block table
    of distinct ids per row with pad entries past kv_len (-1 on odd rows,
    other ids on even ones) and a negative id in a live entry, kv_len with a
    0 and a mid-block end."""
    import torch
    q = torch.randn((B, Hq, D), generator=gen).to(dt).cuda()
    if store_layout:
        k, v = (torch.randn((nb, bs, Hkv, D), generator=gen).to(dt).cuda()
                .permute(0, 2, 1, 3) for _ in range(2))
    else:
        k, v = (torch.randn((nb, Hkv, bs, D), generator=gen).to(dt).cuda()
                for _ in range(2))
    bt = torch.stack([torch.randperm(nb, generator=gen)[:mb]
                      for _ in range(B)]).to(torch.int32)
    lens = torch.randint(1, mb * bs + 1, (B,), generator=gen)
    if B > 1:
        lens[0] = 0
    lens[-1] = bs + bs // 2
    for b in range(B):
        live = -(-int(lens[b]) // bs)
        if b % 2:
            bt[b, live:] = -1
        if b == 1 and live > 1:
            bt[b, 0] = -3                   # reads block 0
    return q, k, v, bt.cuda(), lens.to(torch.int32).cuda()


def _gather_rows(pool, bt):
    """(n_blocks, Hkv, bs, D) pool -> (B, Hkv, max_blocks * bs, D) cache."""
    B, mb = bt.shape
    g = pool[bt.long().clamp(min=0)]            # (B, mb, Hkv, bs, D)
    return g.permute(0, 2, 1, 3, 4).reshape(B, pool.shape[1],
                                            mb * pool.shape[2], -1)


def phase_paged_kernel():
    """The paged kernel against its plain version, and bit for bit equal to
    the decode kernel on the gathered cache (max_blocks * bs positions: the
    same spans and splits); NaN in unreferenced blocks changes nothing;
    pools the 16-byte copies cannot take raise ValueError."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(8)
    n = n_equal = 0
    errs = {k: 0.0 for k in TOL}
    for dname, dt in _dtypes().items():
        for B, Hq, Hkv, nb, bs, mb, D in PAGED_CASES:
            for layout in (False, True):
                q, k, v, bt, lens = _paged_case(B, Hq, Hkv, nb, bs, mb, D,
                                                dt, gen, layout)
                case = (dname, B, Hq, Hkv, nb, bs, mb, D, layout)
                got = ops.paged_gqa_decode_attention(q, k, v, bt, lens)
                torch.cuda.synchronize()
                want = ref.paged_gqa_decode(q, k, v, bt, lens)
                errs[dname] = max(errs[dname], _check_close(
                    "paged", got, want, dname, case))
                dec = ops.gqa_decode_attention(q, _gather_rows(k, bt),
                                               _gather_rows(v, bt), lens)
                assert torch.equal(got, dec), ("paged != decode on the "
                                               "gathered cache", case,
                                               _err(got, dec))
                n_equal += 1
                for b in range(B):
                    if int(lens[b]) <= 0:
                        assert not got[b].any(), ("kv_len 0", case)
                # NaN in every block no live position references
                live = set()
                for b in range(B):
                    for j in range(-(-int(lens[b]) // bs)):
                        live.add(max(int(bt[b, j]), 0))
                dead = [x for x in range(nb) if x not in live]
                k2, v2 = k.clone(), v.clone()
                k2[dead] = float("nan")
                v2[dead] = float("nan")
                dirty = ops.paged_gqa_decode_attention(q, k2, v2, bt, lens)
                assert torch.equal(dirty, got), ("unreferenced NaN", case)
                n += 2
    # a pool view with a row stride of 264 bytes, and one 2 bytes past an
    # aligned address
    q, k, v, bt, lens = _paged_case(8, 16, 8, 96, 16, 24, 128,
                                    torch.bfloat16, gen, True)
    odd = torch.zeros((96, 8, 16, 132), dtype=torch.bfloat16,
                      device="cuda")[..., :128]
    raw = torch.zeros(k.numel() + 8, dtype=torch.bfloat16, device="cuda")
    refused = 0
    for bad in (odd, raw[1:1 + k.numel()].view(96, 8, 16, 128)):
        try:
            ops.paged_gqa_decode_attention(q, bad, bad, bt, lens)
        except ValueError:
            refused += 1
    assert refused == 2, refused
    row = {"phase": "paged_kernel", "cases": n, "max_abs_err": errs,
           "equal_to_decode_kernel": n_equal, "unaligned_refused": refused}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the session serving path with prefix reuse
# ---------------------------------------------------------------------------

def _teacher_forced(model, cfg, run):
    """Every served token of ``run`` a teacher-forced maximum of
    ``train_logits`` on the card; returns (tokens checked, worst gap)."""
    import torch
    from repro_torch.models import lm
    worst, n = 0.0, 0
    for rid, r in run.results.items():
        toks = r["tokens"]
        L = len(run.prompts[rid])
        seq = list(run.prompts[rid]) + toks[:-1]
        logits = lm.train_logits(model, cfg, torch.tensor(
            [seq], device="cuda"))[0, L - 1:]
        for j, t in enumerate(toks):
            ok, rel = _near_tie_ok(logits[j], t)
            assert ok, (rid, j, rel)
            worst = max(worst, rel)
            n += 1
        del logits
    return n, worst


def _median_extend_shape(run):
    """(S_pre buffer, padded suffix, prefix_len) of the cached run's median
    admission by prefix length, as the engine ran it."""
    e = run.engine.ecfg
    hits = sorted((r["cached_tokens"], len(run.prompts[rid]))
                  for rid, r in run.results.items() if r["cached_tokens"])
    plen, L = hits[len(hits) // 2]
    Sn_pad = min(-(-(L - plen) // e.prefill_bucket) * e.prefill_bucket,
                 e.max_seq)
    if plen + Sn_pad <= e.max_seq:          # the bucketed admission
        return (e.max_seq // e.block_size) * e.block_size, Sn_pad, plen
    return plen, L - plen, plen


def phase_serve_sessions(model, cfg):
    import torch
    from repro_torch import serve
    from repro_torch.serving import LLMEngine
    tr = serve.build_session_trace(serve.SessionConfig(), seed=0)
    # warm-up at the session engine's shapes (the first 6 requests)
    warm = LLMEngine(cfg, model, serve.SESSION_ENGINE, device="cuda")
    for rid, req in enumerate(tr.requests[:6]):
        warm.submit(rid, serve.tokenize(req, cfg.vocab), max_new_tokens=4)
    warm.run_to_completion(chunk=serve.CHUNK)
    del warm

    # with and without reuse in turns (on, off, off, on): the host's speed
    # drifts within a call, so each mode's mean spans the same window
    runs, out = {}, {"prefix_cache": [], "no_prefix_cache": []}
    for cache in (True, False, False, True):
        zero_launches()
        run = serve.run_serve(cfg=cfg, model=model, device="cuda",
                              sessions=True, prefix_cache=cache)
        e = run.engine
        launches = launch_counts(
            gqa_decode_attention=cfg.n_layers * e._steps,
            flash_attention=cfg.n_layers * e.admissions)
        assert sorted(run.results) == list(range(tr.n_requests))
        assert e.admissions == tr.n_requests
        for rid, r in run.results.items():
            assert len(r["tokens"]) == run.budgets[rid], rid
            assert all(0 <= t < cfg.vocab for t in r["tokens"]), rid
        tokens = sum(len(r["tokens"]) for r in run.results.values())
        runs.setdefault(cache, run)
        out["prefix_cache" if cache else "no_prefix_cache"].append({
            "launches": launches, "decode_iterations": e._steps,
            "admissions": e.admissions, "tokens": tokens,
            "wall_s": run.wall_s, "tokens_per_s": tokens / run.wall_s,
            "admission_ms_mean": 1e3 * e.prefill_seconds / e.admissions,
            "decode_iteration_ms_mean": 1e3 * e.decode_seconds / e._steps,
            "host_syncs": e.host_syncs, "qoe": e.qoe_summary(),
            "cache_stats": e.cache_stats()})
    means = {name: {k: statistics.mean(r[k] for r in rs)
                    for k in ("tokens_per_s", "admission_ms_mean",
                              "decode_iteration_ms_mean")}
             for name, rs in out.items()}
    cached, plain = runs[True], runs[False]
    st = cached.engine.cache_stats()
    assert st["lookups"] == tr.n_requests and st["evictions"] == 0
    assert st["prefill_tokens_run"] < st["prefill_tokens_total"]
    pool = cached.engine.kv.cache.pool
    leaked = int((pool.ref > 0).sum())
    assert leaked == 0, f"{leaked} blocks still pinned"
    cached.engine.kv.cache.check_invariants()
    print("\n".join(serve.format_run(cached)[:3] + ["  ..."]
                    + serve.format_run(cached)[-2:]), flush=True)

    checked = {}
    for name, run in (("prefix_cache", cached), ("no_prefix_cache", plain)):
        n_tok, worst = _teacher_forced(model, cfg, run)
        checked[name] = {"teacher_forced_tokens": n_tok,
                         "worst_gap_over_max_logit": worst}
    # where the two runs part, the uncached run's row is a near-tie
    from repro_torch.models import lm
    parts = []
    differing = 0
    for rid, want in plain.results.items():
        a, b = cached.results[rid]["tokens"], want["tokens"]
        differing += sum(x != y for x, y in zip(a, b))
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = list(plain.prompts[rid]) + b[:j]
        row = lm.train_logits(model, cfg, torch.tensor(
            [seq], device="cuda"))[0, -1]
        top2 = row.topk(2).values
        gap = float(top2[0] - top2[1]) / float(row.abs().max())
        parts.append({"request": rid, "position": j, "top2_gap": gap})
        assert gap < 2e-2, ("cached and uncached runs part away from a "
                            "near-tie", rid, j, gap)

    # one decode iteration with every slot busy, profiled
    prof_eng = LLMEngine(cfg, model, serve.SESSION_ENGINE, device="cuda")
    for rid, req in enumerate(tr.requests[:serve.SESSION_ENGINE.max_slots]):
        prof_eng.submit(rid, serve.tokenize(req, cfg.vocab),
                        max_new_tokens=64)
    prof = _profile_step(prof_eng)
    del prof_eng
    S_pre, Sq, plen = _median_extend_shape(cached)
    row = {"phase": "serve_sessions", "model": cfg.name,
           "engine": dataclasses.asdict(serve.SESSION_ENGINE),
           "chunk": serve.CHUNK, "requests": tr.n_requests,
           "prompt_tokens": st["prefill_tokens_total"], "runs": out,
           "means": means,
           "prefill_tokens_run_over_total": (st["prefill_tokens_run"]
                                             / st["prefill_tokens_total"]),
           "leaked_blocks": leaked, "checks": checked,
           "cached_vs_uncached": {"diverged_requests": len(parts),
                                  "differing_tokens": differing,
                                  "divergences": parts},
           "decode_iteration_profile": prof,
           "decode_at_profiled_iteration": decode_timing(
               prof["decode_kv_len"], Smax=serve.SESSION_ENGINE.max_seq),
           "flash_extend_at_median_admission": extend_timing(S_pre, Sq,
                                                             plen)}
    emit(row)
    return cached, row


def paged_bound(lens, B, mb, Hq=16, Hkv=8, D=128):
    """Least time of one paged decode call (bf16): q read and out written
    once, the K/V rows up to each kv_len read once, the table and kv_len
    read once; 4 * sum(kv_len) * Hq * D operations."""
    n_read = sum(lens)
    nbytes = 2 * (2 * B * Hq * D + 2 * n_read * Hkv * D) + 4 * B * mb + 4 * B
    ops_n = 4 * n_read * Hq * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_paged_on_pools(run, cfg):
    """The paged kernel over the pools the session run filled: block tables
    from each served prompt's cached blocks (``index.match``), 8 rows a
    batch, the last row ending mid-block; on every layer bit for bit equal
    to the decode kernel on the gathered cache, and against the plain
    version."""
    import torch
    from repro_torch.kernels import decode_attention, ops, ref
    store = run.engine.kv
    bs = store.block_size
    tables = [store.cache.index.match(run.prompts[rid])
              for rid in sorted(run.prompts)]
    tables = [t for t in tables if t]
    gen = torch.Generator().manual_seed(9)
    B = run.engine.ecfg.max_slots
    n = 0
    err = 0.0
    timing = None
    for i0 in range(0, len(tables), B):
        rows = tables[i0:i0 + B]
        mb = max(len(t) for t in rows)
        bt = torch.full((len(rows), mb), -1, dtype=torch.int32)
        for b, t in enumerate(rows):
            bt[b, :len(t)] = torch.tensor(t, dtype=torch.int32)
        lens = [len(t) * bs for t in rows]
        lens[-1] -= bs // 2
        bt, kl = bt.cuda(), torch.tensor(lens, dtype=torch.int32,
                                         device="cuda")
        gk, gv = (torch.stack([x[:, 0] for x in pair], dim=1)
                  for pair in zip(*(store.gather(t, pad_to=mb)
                                    for t in rows)))   # (L, B, S, H, D)
        for li in range(cfg.n_layers):
            q = torch.randn((len(rows), cfg.n_heads, cfg.hd),
                            generator=gen).to(store.k.dtype).cuda()
            kp = store.k[li].permute(0, 2, 1, 3)
            vp = store.v[li].permute(0, 2, 1, 3)
            got = ops.paged_gqa_decode_attention(q, kp, vp, bt, kl)
            torch.cuda.synchronize()
            dec_kv = (gk[li].permute(0, 2, 1, 3), gv[li].permute(0, 2, 1, 3))
            dec = ops.gqa_decode_attention(q, *dec_kv, kl)
            plain = ref.paged_gqa_decode(q, kp, vp, bt, kl)
            case = ("pools", i0, li)
            err = max(err, _check_close("paged on pools", got, plain,
                                        "bfloat16", case))
            assert torch.equal(got, dec), ("paged != decode on the gathered "
                                           "cache", case, _err(got, dec))
            n += 1
            if timing is None and len(rows) == B:
                bound, by = paged_bound(lens, B, mb, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd)
                timing = dict(
                    shape={"B": B, "Hq": cfg.n_heads, "Hkv": cfg.n_kv_heads,
                           "D": cfg.hd, "block_size": bs,
                           "n_blocks": store.k.shape[1], "max_blocks": mb,
                           "kv_len": lens, "dtype": "bfloat16",
                           "layout": "store (n_blocks, bs, Hkv, D)"},
                    ms=time_ms(ops.paged_gqa_decode_attention, q, kp, vp, bt,
                               kl),
                    device_ms=device_kernel_ms(
                        ops.paged_gqa_decode_attention, q, kp, vp, bt, kl,
                        name=PAGED_KERNEL),
                    plain_ms=time_ms(ref.paged_gqa_decode, q, kp, vp, bt, kl),
                    decode_kernel_on_gathered_ms=time_ms(
                        ops.gqa_decode_attention, q, *dec_kv, kl),
                    decode_kernel_on_gathered_device_ms=device_kernel_ms(
                        ops.gqa_decode_attention, q, *dec_kv, kl,
                        name=DECODE_KERNEL),
                    bound_ms=bound, bound_by=by, library_ms=None)
                span, splits = decode_attention.decode_split(
                    B, cfg.n_kv_heads, mb * bs, torch.cuda
                    .get_device_properties(0).multi_processor_count)
                grids, windows = device_kernel_grids(
                    ops.paged_gqa_decode_attention, q, kp, vp, bt, kl,
                    name=PAGED_KERNEL)
                assert grids and set(grids) == {
                    (splits, cfg.n_kv_heads, B)}, (grids, splits, windows)
                timing.update(span=span, splits=splits,
                              blocks_per_call=splits * cfg.n_kv_heads * B,
                              grid_profile_windows=windows)
    assert n and timing is not None
    row = {"phase": "paged_on_pools", "prompts": len(tables),
           "calls": n, "layers": cfg.n_layers, "max_abs_err": err,
           "equal_to_decode_kernel": n, "timing": timing,
           "library": "none: no PyTorch call reads a block table"}
    emit(row)
    return row



# ---------------------------------------------------------------------------
# the cluster server end to end
# ---------------------------------------------------------------------------

def _served_by(srv, rid, res):
    """The pair whose engine produced the result ``res`` of request
    ``rid``."""
    return next(p for p, e in srv.engines.items()
                if e.results.get(rid) is res)


def _cluster_teacher_forced(run):
    """Every served token of a launcher run a teacher-forced maximum of its
    pair's model (``train_logits`` on the card); (tokens checked, worst gap
    over max|logit|)."""
    import torch
    from repro_torch.models import lm
    srv, worst, n = run.server, 0.0, 0
    for rid, r in run.done.items():
        e = srv.engines[_served_by(srv, rid, r)]
        prompt = srv._tokenize(run.trace.requests[rid], e.cfg.vocab)
        seq = list(prompt) + r["tokens"][:-1]
        logits = lm.train_logits(e.model, e.cfg, torch.tensor(
            [seq], device="cuda"))[0, len(prompt) - 1:]
        for j, t in enumerate(r["tokens"]):
            ok, rel = _near_tie_ok(logits[j], t)
            assert ok, (rid, j, rel)
            worst = max(worst, rel)
            n += 1
        del logits
    return n, worst


def _own_tokens(e):
    """Tokens an engine emitted in its own decodes: an adopted engine's
    count less what its cohort's dispatches committed for it."""
    if e._fleet is None:
        return e.tokens_emitted
    cohort, m = e._fleet
    return e.tokens_emitted - int(cohort.counters.emitted[m])


def _cluster_accounting(run):
    """Completion, conservation, drained queues, the fleet counters against
    the engines, and the failed node (the only node down) left with no
    served request, its failures the reroutes."""
    srv = run.server
    assert sorted(run.done) == list(range(CLUSTER_REQUESTS))
    for rid, r in run.done.items():
        assert len(r["tokens"]) == run.budgets[rid], rid
    for node, s in srv.monitor.stats.items():
        assert s.total_dispatched == (s.total_completed + s.total_failed
                                      + s.total_cancelled), (node, s)
        assert s.outstanding == 0, (node, s)
    st = srv.stats()
    assert all(q == 0 for q in st["queue_lengths"]), st["queue_lengths"]
    assert st["active"] == st["queued"] == 0
    engines = list(srv.engines.values())
    assert st["active"] == sum(e.active_count for e in engines)
    emitted = sum(e.tokens_emitted for e in engines)
    assert st["fleet"]["emitted"] == sum(c["emitted"] for c in st["cohorts"])
    own = [_own_tokens(e) for e in engines]
    # an engine emits tokens of its own only in decodes of its own
    for e, n in zip(engines, own):
        assert 0 <= n <= e.decode_iterations * e.ecfg.max_slots, (n, e)
    # no prefix cache at these engines: the check holds only vacuously
    leaked = sum(int((e.kv.cache.pool.ref > 0).sum()) for e in engines
                 if e.kv is not None)
    assert leaked == 0
    assert srv._down_nodes == {CLUSTER_FAIL[0]}, srv._down_nodes
    pair_node = srv.router.arrays.pair_node
    served_on = {int(pair_node[_served_by(srv, rid, r)])
                 for rid, r in run.done.items()}
    assert CLUSTER_FAIL[0] not in served_on, served_on
    assert (srv.monitor.stats[CLUSTER_FAIL[0]].total_failed
            == st["reroutes"]), st["reroutes"]
    return st, emitted, sum(own), leaked


def _cluster_launches(srv, tuned):
    """The run's launches, held to the arithmetic: dominance 1 + generations
    when tuned, flash n_layers per admission, decode n_layers per cohort
    iteration plus per engine-own iteration."""
    engines = list(srv.engines.values())
    return launch_counts(
        dominance_matrix=1 + CLUSTER_GENS if tuned else 0,
        flash_attention=sum(e.cfg.n_layers * e.admissions for e in engines),
        gqa_decode_attention=(
            sum(c.cfg.n_layers * c.counters.iterations for c in srv._cohorts)
            + sum(e.cfg.n_layers * e.decode_iterations for e in engines)))


def _parting(e, prompt, ta, tb, **key):
    """Where two token streams of one request first part, both tokens are
    near-tie maxima of the model's logits there (teacher forcing on the
    card); the parting with its top-2 gap over max|logit|."""
    import torch
    from repro_torch.models import lm
    j = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
    row = lm.train_logits(e.model, e.cfg, torch.tensor(
        [list(prompt) + list(ta[:j])], device="cuda"))[0, -1]
    for t in (ta[j], tb[j]):
        ok, rel = _near_tie_ok(row, t)
        assert ok, ("token streams part away from a near-tie", key, j, t,
                    rel)
    top2 = row.topk(2).values
    return dict(key, position=j,
                top2_gap=float(top2[0] - top2[1]) / float(row.abs().max()))


def _saturated_server(models, fleet):
    """A full-width server with every slot of every engine busy (64-token
    budgets), admitted directly on each pair."""
    from repro_torch.core.policies.threshold import PAPER_DEFAULTS
    from repro_torch.launch import serve as launch
    from repro_torch.serving import ClusterServer, ServeRequest
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.workload.trace import build_trace
    srv = ClusterServer(paper_testbed(), models, PAPER_DEFAULTS,
                        launch.FULL_ENGINE, hedge_after=10 ** 9,
                        fleet=fleet, device="cuda")
    tr = build_trace(64, seed=0)
    rid = 0
    for pair in srv.engines:
        for _ in range(launch.FULL_ENGINE.max_slots):
            srv._dispatch(ServeRequest(request_id=rid,
                                       req=tr.requests[rid % 64],
                                       max_new_tokens=64), pair)
            rid += 1
    assert all(e.active_count == launch.FULL_ENGINE.max_slots
               for e in srv.engines.values())
    return srv


def _saturated_partings(a, b):
    """Every slot's generated tokens of two saturated servers that took the
    same requests and ticks (fleet on and off): the same lengths, parting
    only at near-ties. Returns (tokens compared, partings)."""
    from repro_torch.workload.trace import build_trace
    tr = build_trace(64, seed=0)
    n, parts = 0, []
    for pair, ea in a.engines.items():
        eb = b.engines[pair]
        for sa, sb in zip(ea.slots, eb.slots):
            assert sa.request_id == sb.request_id, pair
            ta, tb = sa.generated, sb.generated
            assert len(ta) == len(tb), (pair, sa.request_id)
            n += len(ta)
            if ta != tb:
                prompt = a._tokenize(tr.requests[sa.request_id % 64],
                                     ea.cfg.vocab)
                parts.append(_parting(ea, prompt, ta, tb, pair=pair,
                                      request=sa.request_id))
    return n, parts


def _tick_walls(srv, n=5):
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _profile_tick(srv, wall):
    """One saturated tick profiled: the card's busy time against ``wall``,
    the median host time of an unprofiled tick (the profiler inflates the
    host's), and the top device and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name, host = Counter(), Counter()
    n_events = 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by_name[ev.name[:60]] += ev.time_range.elapsed_us()
            n_events += 1
        else:
            host[ev.name[:60]] += ev.self_cpu_time_total
    busy = sum(by_name.values()) / 1e6
    return {"tick_wall_s": wall, "profiled_tick_wall_s": prof_wall,
            "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_events": n_events,
            "top_device_us": by_name.most_common(8),
            "top_host_self_us": host.most_common(8)}


def _check_models():
    """The launcher's model map at full width and 2 layers a model."""
    from repro_torch import serve
    from repro_torch.configs import get
    from repro_torch.launch import serve as launch
    models = {}
    for names, arch, seed in ((launch.CLOUD_NAMES, launch.CLOUD_MODEL, 0),
                              (launch.EDGE_NAMES, launch.EDGE_MODEL, 1)):
        cfg = dataclasses.replace(get(arch).config(),
                                  n_layers=CHECK_LAYERS)
        m = serve.build_model(cfg, "cuda", seed=seed)
        models.update({n: (cfg, m) for n in names})
    return models


def _fleet_vs_engines(models, thresholds):
    """The launcher's run on ``models``, fleet on and off, on the card:
    the same routing decisions, QoE records and token counts, node 1 the
    only node down with its failures the reroutes; tokens may part only at
    near-ties (teacher forcing on the card)."""
    from repro_torch.launch import serve as launch
    from repro_torch.obs import Obs
    runs = {}
    for fleet in (True, False):
        o = Obs()
        runs[fleet] = (launch.run_launch(
            CLUSTER_REQUESTS, device="cuda", models=models,
            thresholds=thresholds, fail_node=CLUSTER_FAIL[0],
            fail_at=CLUSTER_FAIL[1], fleet=fleet, obs=o), o)
    (a, oa), (b, ob) = runs[True], runs[False]
    assert [r.key() for r in oa.audit.records()] == \
        [r.key() for r in ob.audit.records()]
    assert sorted(a.done) == sorted(b.done)
    sa, sb = a.server.stats(), b.server.stats()
    for k in sa:
        if k not in ("cohorts", "decode_dispatches", "fleet"):
            assert sa[k] == sb[k], k
    for srv in (a.server, b.server):
        assert srv._down_nodes == {CLUSTER_FAIL[0]}, srv._down_nodes
    assert (a.server.monitor.stats[CLUSTER_FAIL[0]].total_failed
            == sa["reroutes"]), sa["reroutes"]
    parts, differing = [], 0
    for rid, ra in a.done.items():
        rb = b.done[rid]
        assert {k: v for k, v in ra.items() if k != "tokens"} == \
            {k: v for k, v in rb.items() if k != "tokens"}, rid
        ta, tb = ra["tokens"], rb["tokens"]
        assert len(ta) == len(tb), rid
        differing += sum(x != y for x, y in zip(ta, tb))
        if ta != tb:
            e = a.server.engines[_served_by(a.server, rid, ra)]
            prompt = a.server._tokenize(a.trace.requests[rid], e.cfg.vocab)
            parts.append(_parting(e, prompt, ta, tb, request=rid))
    return {"layers": CHECK_LAYERS, "requests": len(a.done),
            "reroutes": sa["reroutes"], "hedges": sa["hedges"],
            "route_decisions": len(oa.audit),
            "tokens": sum(len(r["tokens"]) for r in a.done.values()),
            "fleet_decode_dispatches": sa["decode_dispatches"],
            "engine_decode_dispatches": sb["decode_dispatches"],
            "fleet_wall_s": a.wall_s, "engine_wall_s": b.wall_s,
            "diverged_requests": len(parts), "differing_tokens": differing,
            "divergences": parts}


def _served_summary(run, st, emitted, own):
    srv = run.server
    tokens = sum(len(r["tokens"]) for r in run.done.values())
    return {"requests": len(run.done), "tokens": tokens,
            "wall_s": run.wall_s, "tokens_per_s": tokens / run.wall_s,
            "ticks": srv.ticks, "reroutes": st["reroutes"],
            "hedges": st["hedges"], "cancelled": st["cancelled"],
            "decode_dispatches": st["decode_dispatches"],
            "cohort_participants": [int(x) for x in srv.metrics.counter(
                "cohort_participants").values],
            "fleet": st["fleet"], "engine_tokens_emitted": emitted,
            "engine_own_tokens_emitted": own,
            "percentiles": {k: st["percentiles"][k]
                            for k in ("latency", "ttft", "tpot")}}


def _cohort_rows(srv):
    return [{"model": c.cfg.name, "layers": c.cfg.n_layers,
             "members": len(c), "rows": len(c) * c.ecfg.max_slots,
             "dispatches": c.counters.dispatches,
             "iterations": c.counters.iterations,
             "emitted": int(c.counters.emitted.sum()),
             "decode_ms_per_iteration": (
                 1e3 * c.counters.decode_seconds / c.counters.iterations
                 if c.counters.iterations else None)}
            for c in srv._cohorts]


def phase_cluster():
    import torch
    from repro_torch.core.policies.threshold import PAPER_DEFAULTS
    from repro_torch.launch import serve as launch
    t0 = time.perf_counter()
    models = launch.build_models("cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # warm-up: both models admit and decode at the engines' shapes
    launch.run_launch(4, device="cuda", models=models)
    torch.cuda.reset_peak_memory_stats()

    # run A: the launcher's tuned router
    zero_launches()
    run = launch.run_launch(CLUSTER_REQUESTS, device="cuda",
                            optimize_router=True, generations=CLUSTER_GENS,
                            fail_node=CLUSTER_FAIL[0],
                            fail_at=CLUSTER_FAIL[1], models=models)
    srv = run.server
    engines = list(srv.engines.values())
    launches = _cluster_launches(srv, tuned=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st, emitted, own, leaked = _cluster_accounting(run)
    n_tok, worst = _cluster_teacher_forced(run)
    by_model = {}
    for e in engines:
        m = by_model.setdefault(e.cfg.name, {
            "layers": e.cfg.n_layers, "engines": 0, "admissions": 0,
            "own_decode_iterations": 0, "prefill_s": 0.0})
        m["engines"] += 1
        m["admissions"] += e.admissions
        m["own_decode_iterations"] += e.decode_iterations
        m["prefill_s"] += e.prefill_seconds
    cohorts = _cohort_rows(srv)
    served = _served_summary(run, st, emitted, own)
    served.update(tuning_s=run.tuned.seconds,
                  thresholds=[float(x) for x in run.tuned.thresholds],
                  objectives=[float(x) for x in run.tuned.objectives])
    thresholds = run.tuned.thresholds
    print(f"cluster: {len(run.done)} requests, {served['tokens']} tokens "
          f"in {run.wall_s:.3f} s, {srv.ticks} ticks, reroutes "
          f"{st['reroutes']}, hedges {st['hedges']}", flush=True)
    del run, srv, engines

    # run B: the paper's default thresholds, which send node 1 traffic, so
    # its failure cancels and re-routes live flights
    zero_launches()
    run = launch.run_launch(CLUSTER_REQUESTS, device="cuda",
                            thresholds=PAPER_DEFAULTS,
                            fail_node=CLUSTER_FAIL[0],
                            fail_at=CLUSTER_FAIL[1], models=models)
    launches_b = _cluster_launches(run.server, tuned=False)
    st_b, emitted_b, own_b, _ = _cluster_accounting(run)
    assert st_b["reroutes"] > 0, "node 1 held no flight when it failed"
    n_tok_b, worst_b = _cluster_teacher_forced(run)
    served_b = _served_summary(run, st_b, emitted_b, own_b)
    served_b.update(cohorts=_cohort_rows(run.server),
                    teacher_forced_tokens=n_tok_b,
                    worst_gap_over_max_logit=worst_b, launches=launches_b)
    print(f"cluster, paper defaults: {served_b['tokens']} tokens in "
          f"{run.wall_s:.3f} s, reroutes {st_b['reroutes']}, hedges "
          f"{st_b['hedges']}", flush=True)
    del run

    # a saturated tick, fleet against the per-engine loop, in turns
    walls = {True: [], False: []}
    sat = {f: _saturated_server(models, f) for f in (True, False)}
    for f in (True, False, False, True):
        walls[f] += _tick_walls(sat[f], n=3)
    sat_tokens, sat_parts = _saturated_partings(sat[True], sat[False])
    fsrv = sat[True]
    edge = max(fsrv._cohorts, key=len)
    cloud = min(fsrv._cohorts, key=len)
    lens = (edge.state.cache.kv_len + 1).tolist()   # the profiled tick's
    cloud_lens = (cloud.state.cache.kv_len + 1).tolist()
    prof = _profile_tick(fsrv, statistics.median(walls[True]))
    prof.update(decode_kv_len=lens, cloud_decode_kv_len=cloud_lens)
    del sat, fsrv
    Smax = launch.FULL_ENGINE.max_seq
    dec = decode_timing(lens, Smax=Smax, Hq=edge.cfg.n_heads,
                        Hkv=edge.cfg.n_kv_heads, D=edge.cfg.hd)
    dec_cloud = decode_timing(cloud_lens, Smax=Smax, Hq=cloud.cfg.n_heads,
                              Hkv=cloud.cfg.n_kv_heads, D=cloud.cfg.hd)
    del edge, cloud
    small = _check_models()
    check = {"tuned": _fleet_vs_engines(small, thresholds),
             "paper_defaults": _fleet_vs_engines(small, PAPER_DEFAULTS)}
    assert check["paper_defaults"]["reroutes"] > 0
    del small
    total = {k: launches[k] + launches_b[k] for k in launches}
    row = {"phase": "cluster", "requests": CLUSTER_REQUESTS,
           "models": {c.name: {"layers": c.n_layers,
                               "params": c.param_counts()["total"]}
                      for c, _ in models.values()},
           "engine": dataclasses.asdict(launch.FULL_ENGINE),
           "chunk": launch.FULL_CHUNK, "generations": CLUSTER_GENS,
           "pop": launch.POP, "fail_node_after": list(CLUSTER_FAIL),
           "init_s": init_s, "launches": total, "launches_tuned": launches,
           "served": served, "by_model": by_model, "cohorts": cohorts,
           "served_paper_defaults": served_b,
           "leaked_blocks": leaked, "teacher_forced_tokens": n_tok,
           "worst_gap_over_max_logit": worst, "peak_memory_gb": peak_gb,
           "saturated_tick_s": {
               "fleet": walls[True], "per_engine": walls[False],
               "fleet_median": statistics.median(walls[True]),
               "per_engine_median": statistics.median(walls[False])},
           "saturated_tokens_compared": sat_tokens,
           "saturated_partings": sat_parts,
           "saturated_tick_profile": prof,
           "decode_at_cohort_rows": dec, "decode_at_cloud_rows": dec_cloud,
           "fleet_vs_per_engine": check}
    emit(row)
    return row


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA device; it runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    sorted_F = SortedObjectives()
    smi = timed("card", phase_card)
    kern = timed("kernels", phase_kernels)
    res, launches = timed("main_path", phase_main_path, sorted_F)
    timed("profile", phase_profile, res.state.genomes)
    timed("device_vs_cpu", phase_device_vs_cpu, res.genome)
    large = timed("large_population", phase_large_population, sorted_F)
    counts = timed("counts_kernel", phase_counts_kernel, sorted_F)
    onl = timed("online", phase_online)
    mat = timed("policy_matrix", phase_policy_matrix)
    attn = timed("attention_kernels", phase_attention_kernels)
    paged = timed("paged_kernel", phase_paged_kernel)
    run, model, served = timed("serve", phase_serve)
    timed("serve_check", phase_serve_check, run, model)
    sess_run, sess = timed("serve_sessions", phase_serve_sessions, model,
                           run.cfg)
    pools = timed("paged_on_pools", phase_paged_on_pools, sess_run, run.cfg)
    clu = timed("cluster", phase_cluster)
    emit({"phase": "times", "card": smi, "seconds": phase_s,
          "total_s": sum(phase_s.values())})

    t200 = kern["timing"]["200"]
    c200, c4096 = counts["timing"]["200"], counts["timing"]["4096"]
    dec, fa = attn["decode"], attn["flash"]
    ext = sess["flash_extend_at_median_admission"]
    sess_launches = sess["runs"]["prefix_cache"][0]["launches"]
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library_device_ms", "device_ms", "shape")
    emit({"kernels": [{
        "name": "dominance_matrix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dominance.cu",
        "replaces": "src/repro/kernels/dominance.py:47",
        "launches": launches, "launches_large_population": large,
        "launches_online": onl["launches"],
        "launches_online_refit_256": onl["refit_256"]["launches"],
        "launches_cluster": clu["launches"]["dominance_matrix"],
        "launches_policy_matrix": mat["launches"],
        "launches_policy_matrix_refits": {
            m: r["launches"] for m, r in mat["refits"].items()},
        **onl["timing"],
        "cases": kern["cases"], "exact": kern["exact"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t200["ms"], "plain_ms": t200["plain_ms"],
        "bound_ms": t200["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": t200["device_ms"],
        "p4096": {**kern["timing"]["4096"], "bound_by": "bytes"},
        "p4104": {**kern["timing"]["4104"], "bound_by": "bytes"},
        "kernel_names": kern["kernel_names"],
        "previous": "PERF.md section 6, column Previous"}, {
        "name": "dominance_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dominance.cu",
        "replaces": "src/repro/kernels/dominance.py:90",
        # no path runs it: launch_counts held it at 0 in phases 3, 5, 7, 11
        "launches": sess_launches["dominance_counts"],
        "on_main_path": False,
        "held_on_main_path_matrices": counts["main_path_matrices"],
        "cases": counts["cases"], "exact": counts["exact"],
        "max_abs_err": counts["max_abs_err"],
        **{k: c200[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms")},
        "library": counts["library"], "p4096": c4096}, {
        "name": "gqa_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "kernel_body": "src/repro_torch/kernels/csrc/split_decode.cuh",
        "replaces": "src/repro/kernels/decode_attention.py:79",
        "launches": served["launches"]["gqa_decode_attention"],
        "launches_serve_sessions": sess_launches["gqa_decode_attention"],
        "launches_cluster": clu["launches"]["gqa_decode_attention"],
        "cases": dec["cases"],
        "max_abs_err": max(dec["max_abs_err"].values()),
        "max_abs_err_by_dtype": dec["max_abs_err"],
        **{k: dec["serving"].get(k) for k in timing_keys},
        "full_cache": dec["full_cache"],
        "session": sess["decode_at_profiled_iteration"],
        "cluster_cohort": clu["decode_at_cohort_rows"],
        "cluster_cloud": clu["decode_at_cloud_rows"],
        "splits": attn["routes"]["decode_split"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": served["launches"]["flash_attention"],
        "launches_serve_sessions": sess_launches["flash_attention"],
        "launches_cluster": clu["launches"]["flash_attention"],
        "cases": fa["cases"] + attn["flash_extend"]["cases"],
        "max_abs_err": max(list(fa["max_abs_err"].values())
                           + list(attn["flash_extend"]["max_abs_err"]
                                  .values())),
        "max_abs_err_by_dtype": fa["max_abs_err"],
        **{k: fa["serving"].get(k) for k in timing_keys},
        "s64": fa["s64"], "s512": fa["s512"], "groups": fa["groups"],
        "kernels_by_dtype": attn["routes"]["flash_kernels"],
        "extend": {"cases": attn["flash_extend"]["cases"],
                   "max_abs_err_by_dtype":
                       attn["flash_extend"]["max_abs_err"],
                   **ext}}, {
        "name": "paged_gqa_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "kernel_body": "src/repro_torch/kernels/csrc/split_decode.cuh",
        "replaces": "src/repro/kernels/paged_attention.py:73",
        "launches": sess_launches["paged_gqa_decode_attention"],
        "on_main_path": False,
        "held_on_session_pools": {"calls": pools["calls"],
                                  "max_abs_err": pools["max_abs_err"]},
        "equal_to_decode_kernel": (paged["equal_to_decode_kernel"]
                                   + pools["equal_to_decode_kernel"]),
        "cases": paged["cases"],
        "max_abs_err": max(list(paged["max_abs_err"].values())
                           + [pools["max_abs_err"]]),
        "max_abs_err_by_dtype": paged["max_abs_err"],
        **{k: pools["timing"].get(k) for k in timing_keys},
        "decode_kernel_on_gathered_device_ms":
            pools["timing"]["decode_kernel_on_gathered_device_ms"],
        "splits": pools["timing"]["splits"],
        "previous": "PERF.md section 6, column Previous",
        "library": pools["library"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
