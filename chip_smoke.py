#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and runs
the port's two paths on the card, the routing loop and the serving engine,
in phases that each print one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time;
2. kernels: the dominance kernel against its plain PyTorch version on the
   card (exact), and its time beside the plain version's and the card's
   bound;
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
   +-999 and NaN (output unchanged); then each timed at the serving shapes
   beside its plain version, SDPA and its bound;
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
   tokens, except at the CPU's own near-ties.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failure raises and exits non-zero. Without a CUDA device, or
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
DEC_SMAX = (64, 512, 520)
FA_S = (1, 17, 64, 128, 192, 200, 512)
SERVE_MODEL, SERVE_REQUESTS = "qwen3-1.7b", 32
CHECK_LAYERS, CHECK_REQUESTS = 2, 8
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


def zero_launches():
    from repro_torch.kernels import decode_attention, dominance, flash_attention
    dominance.LAUNCHES = flash_attention.LAUNCHES = 0
    decode_attention.LAUNCHES = 0


def launch_counts(**expected):
    """Every kernel's launch count since ``zero_launches``; a kernel not
    named in ``expected`` must not have launched."""
    from repro_torch.kernels import decode_attention, dominance, flash_attention
    got = {"dominance_matrix": dominance.LAUNCHES,
           "flash_attention": flash_attention.LAUNCHES,
           "gqa_decode_attention": decode_attention.LAUNCHES}
    want = {k: expected.get(k, 0) for k in got}
    assert got == want, f"launches {got}, want {want}"
    return got


def phase_main_path():
    import numpy as np
    from repro_torch.quickstart import format_table, run_quickstart
    zero_launches()
    t0 = time.perf_counter()
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
                                          kl, name="gqa_decode_kernel"),
               plain_ms=time_ms(ref.gqa_decode, q, k, v, kl),
               bound_ms=bound,
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops_n / BF16_OPS_PER_S else "operations"))
    try:
        torch.testing.assert_close(library()[:, :, 0], ops.gqa_decode_attention(
            q, k, v, kl), atol=2e-2, rtol=2e-2)
        out["library_ms"] = time_ms(library)
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
    try:
        torch.testing.assert_close(library(), ops.flash_attention(
            q, k, v, causal), atol=2e-2, rtol=2e-2)
        out["library_ms"] = time_ms(library)
    except (TypeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def phase_attention_kernels():
    n_dec, dec_err = check_decode_kernel()
    n_fa, fa_err = check_flash_kernel()
    lens = _serving_kv_lens()
    row = {"phase": "attention_kernels",
           "decode": {"cases": n_dec, "max_abs_err": dec_err,
                      "serving": decode_timing(lens),
                      "full_cache": decode_timing([512] * 8)},
           "flash": {"cases": n_fa, "max_abs_err": fa_err,
                     "serving": flash_timing(128),
                     "s512": flash_timing(512)}}
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
            "device_events": n_events,
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
    worst = 0.0
    n_tok = 0
    for rid, r in run.results.items():
        toks = r["tokens"]
        seq = list(run.prompts[rid]) + toks[:-1]
        L = len(run.prompts[rid])
        logits = lm.train_logits(model, cfg, torch.tensor(
            [seq], device="cuda"))[0, L - 1:]
        for j, t in enumerate(toks):
            ok, rel = _near_tie_ok(logits[j], t)
            assert ok, (rid, j, rel)
            worst = max(worst, rel)
            n_tok += 1

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
    t = time.perf_counter()
    attn = phase_attention_kernels()
    phase_s["attention_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    run, model, served = phase_serve()
    phase_s["serve"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_serve_check(run, model)
    phase_s["serve_check"] = time.perf_counter() - t
    emit({"phase": "times", "card": smi, "seconds": phase_s,
          "total_s": sum(phase_s.values())})

    t200, t4096 = kern["timing"]["200"], kern["timing"]["4096"]
    dec, fa = attn["decode"], attn["flash"]
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "device_ms", "shape")
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
        "p4096": {**t4096, "bound_by": "bytes"}}, {
        "name": "gqa_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:79",
        "launches": served["launches"]["gqa_decode_attention"],
        "cases": dec["cases"],
        "max_abs_err": max(dec["max_abs_err"].values()),
        "max_abs_err_by_dtype": dec["max_abs_err"],
        **{k: dec["serving"].get(k) for k in timing_keys},
        "full_cache": dec["full_cache"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": served["launches"]["flash_attention"],
        "cases": fa["cases"],
        "max_abs_err": max(fa["max_abs_err"].values()),
        "max_abs_err_by_dtype": fa["max_abs_err"],
        **{k: fa["serving"].get(k) for k in timing_keys},
        "s512": fa["s512"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
