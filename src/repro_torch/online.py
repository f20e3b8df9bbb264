"""Rolling-horizon re-optimization under open-loop workload drift, on the
port: the counterpart of ``benchmarks/online_drift.py``.

The paper claims the routing policy "adapts to dynamic workloads" via
periodic small-scale NSGA-II re-optimization (§IV-B.6). Each scenario is a
sequence of open-loop windows whose arrival rate / category mix / prompt
lengths drift after window 0, and two policies are compared on the
post-drift windows:

* **static** — Algorithm-2 thresholds tuned once on window 0 (the stale
  window) with the 4-objective QoE fitness, then frozen;
* **adaptive** — the runtime router's rolling-horizon loop: after serving
  each window it records the observed requests + realized objectives and
  calls ``RequestRouter.maybe_reoptimize`` (open-loop re-fit on the recorded
  window padded to a power-of-two bucket, NSGA-II warm-started from the
  previous archive, survival through the dominance kernel on the card).

Both start from the identical window-0 policy, so any gap is adaptation.
Reported per (scenario, strategy): post-drift mean quality, mean cost, SLO
attainment, mean RT, and the §V-D-style composite over (quality↑, cost↓,
attainment↑) normalized across strategies (cloud-only is the anchor).

    PYTHONPATH=src python -m repro_torch.online [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from ._device import Device, resolve, synchronize
from .cluster.spec import paper_testbed
from .core import baselines
from .core.fitness import EvalConfig, EvalResult, TraceEvaluator
from .core.nsga2 import NSGA2, NSGA2Config
from .core.policies.threshold import BOUNDS_HI, BOUNDS_LO
from .core.router import RequestRouter, RouteDecision
from .workload.arrivals import PhaseSpec, build_open_loop_trace
from .workload.slo import attach_slos
from .workload.trace import Trace

WINDOW_REQUESTS = 60
N_WINDOWS = 4          # window 0 tunes; windows 1.. are post-drift
POP, GENS = 16, 10

# Each scenario: one PhaseSpec per window. Drift is a step change after the
# tuning window; the adaptive policy has re-fit on window 1's observations by
# window 2 while the static policy stays tuned on stale window 0. The burst
# exceeds the cloud node's service capacity (~7 req/s) and the math-heavy
# long-prompt mix saturates it at a much lower rate, so a policy tuned on
# the calm window (which concentrates traffic on the cloud) collapses on
# attainment unless it re-learns to spill load onto the edge tier.
SCENARIOS = {
    # category-mix + prompt-length drift: easy code-heavy -> hard math-heavy
    "mix_shift": [
        PhaseSpec(rate=2.0, duration=1e9, mix=(0.70, 0.10, 0.10, 0.10)),
    ] + [
        PhaseSpec(rate=4.0, duration=1e9, mix=(0.10, 0.70, 0.10, 0.10),
                  length_scale=1.8),
    ] * (N_WINDOWS - 1),
    # arrival-rate drift: calm tuning window -> sustained overload burst
    "burst": [
        PhaseSpec(rate=1.2, duration=1e9, mix=(0.25, 0.25, 0.25, 0.25)),
    ] + [
        PhaseSpec(rate=10.0, duration=1e9, mix=(0.25, 0.25, 0.25, 0.25)),
    ] * (N_WINDOWS - 1),
}

# Eq. (1)-style selection weights over (RQ, C, RT, V): attainment-leaning,
# applied identically to the static window-0 tuning and every adaptive
# re-fit, so the comparison isolates *adaptation*, not selection taste.
WEIGHTS = (0.20, 0.15, 0.15, 0.50)
STRATEGIES = ("static", "adaptive", "cloud_only")


@dataclasses.dataclass
class WindowStats:
    quality: float
    cost: float
    rt: float
    attainment: float


@dataclasses.dataclass
class WindowRun:
    """One window as the loop served it: its trace, the two threshold
    genomes in force, each strategy's per-request results, and the trace
    the re-fit after it scored genomes on."""

    trace: Trace
    genomes: Dict[str, np.ndarray]      # "static", "adaptive"
    results: Dict[str, EvalResult]      # STRATEGIES
    refit_s: float                      # wall seconds of the re-fit after it
    refit_trace: Trace                  # RequestRouter.window_trace


@dataclasses.dataclass
class ScenarioResult:
    rows: List[list]
    summary: Dict[str, WindowStats]     # post-drift means per strategy
    composite: Dict[str, float]
    windows: List[WindowRun]
    tune_s: float                       # wall seconds of tune_window0


def _make_windows(phases, seed, device):
    """One open-loop trace + evaluator per window."""
    out = []
    for k, ph in enumerate(phases):
        tr = build_open_loop_trace(WINDOW_REQUESTS, (ph,),
                                   seed=seed * 100 + k)
        attach_slos(tr, tightness=1.0, seed=seed * 100 + k)
        out.append((tr, TraceEvaluator(tr, paper_testbed(),
                                       EvalConfig(mode="open"),
                                       device=device)))
    return out


def _stats(ev: TraceEvaluator, res: EvalResult) -> WindowStats:
    s = ev.summarize(res)
    return WindowStats(quality=s["avg_quality"], cost=s["avg_cost"],
                       rt=s["avg_response_time"],
                       attainment=s["slo_attainment"])


def tune_window0(ev: TraceEvaluator, seed: int = 0) -> np.ndarray:
    """The shared starting policy: NSGA-II over window 0's QoE fitness, on
    the evaluator's device."""
    cfg = NSGA2Config(pop_size=POP, n_generations=GENS, lo=BOUNDS_LO,
                      hi=BOUNDS_HI)
    opt = NSGA2(ev.make_fitness("threshold", objectives="qoe"), cfg,
                device=ev.device)
    gen = torch.Generator(device=ev.device).manual_seed(seed)
    state = opt.evolve_scan(gen, GENS)
    genome, _ = opt.select_by_weights(state, WEIGHTS)
    return genome.cpu().numpy()


def _record_window(router: RequestRouter, trace: Trace,
                   res: EvalResult) -> None:
    """Feed one served window into the router's rolling history."""
    q, c, rt, assign = (t.cpu().numpy() for t in (res.q, res.cost, res.rt,
                                                  res.assign))
    pair_node, is_edge = router.arrays.pair_node, router.arrays.pair_is_edge
    for i, req in enumerate(trace.requests):
        p = int(assign[i])
        dec = RouteDecision(
            pair=p, node=int(pair_node[p]), model=0, go_edge=bool(is_edge[p]),
            features=(float(trace.complexity[i]),
                      int(trace.pred_category[i]),
                      float(trace.pred_conf[i])))
        router.record(req, dec, quality=float(q[i]), cost=float(c[i]),
                      rt=float(rt[i]), now=float(trace.arrival_time[i]),
                      ttft_deadline=float(trace.ttft_deadline[i]),
                      tpot_deadline=float(trace.tpot_deadline[i]))


def _composite(summary: Dict[str, WindowStats]) -> Dict[str, float]:
    """§V-D-style composite over (quality ↑, cost ↓, attainment ↑), min-max
    normalized across the compared strategies."""
    names = list(summary)

    def norm(vals, larger_better):
        v = np.asarray(vals, np.float64)
        rng = v.max() - v.min()
        if rng <= 0:
            return np.ones_like(v)
        n = (v - v.min()) / rng
        return n if larger_better else 1.0 - n

    comp = (norm([summary[n].quality for n in names], True)
            + norm([summary[n].cost for n in names], False)
            + norm([summary[n].attainment for n in names], True)) / 3.0
    return dict(zip(names, (float(c) for c in comp)))


def run_scenario(name: str, phases, seed: int = 0,
                 device: Device = None) -> ScenarioResult:
    dev = resolve(device)
    windows = _make_windows(phases, seed, dev)
    cluster = paper_testbed()
    synchronize(dev)
    t0 = time.perf_counter()
    policy0 = tune_window0(windows[0][1], seed=seed)
    synchronize(dev)
    tune_s = time.perf_counter() - t0

    # the adaptive policy lives in the router
    router = RequestRouter(cluster, policy0, device=dev)
    static = policy0.copy()

    rows, runs = [], []
    agg = {s: [] for s in STRATEGIES}
    for k, (tr, ev) in enumerate(windows):
        genomes = {"static": static, "adaptive": router.thresholds.copy()}
        results = {s: ev.run_thresholds(genomes[s])
                   for s in ("static", "adaptive")}
        results["cloud_only"] = ev.run_assignment(
            baselines.cloud_only(tr, cluster))
        for sname in STRATEGIES:
            st = _stats(ev, results[sname])
            rows.append([name, k, sname, f"{st.quality:.4f}",
                         f"{st.cost:.4e}", f"{st.attainment:.4f}",
                         f"{st.rt:.4f}"])
            if k >= 1:                      # post-drift aggregation
                agg[sname].append(st)
        # close the loop: record what the adaptive policy just observed and
        # re-fit (window size = history window; warm start from the archive)
        _record_window(router, tr, results["adaptive"])
        synchronize(dev)
        t0 = time.perf_counter()
        router.maybe_reoptimize(force=True, window=WINDOW_REQUESTS,
                                generations=GENS, pop_size=POP, seed=seed,
                                weights=WEIGHTS)
        synchronize(dev)
        refit_s = time.perf_counter() - t0
        runs.append(WindowRun(
            trace=tr, genomes=genomes, results=results, refit_s=refit_s,
            refit_trace=router.window_trace(WINDOW_REQUESTS, seed)))

    def mean(stats, f):
        return float(np.mean([getattr(s, f) for s in stats]))

    summary = {s: WindowStats(quality=mean(v, "quality"),
                              cost=mean(v, "cost"), rt=mean(v, "rt"),
                              attainment=mean(v, "attainment"))
               for s, v in agg.items()}
    for sname, st in summary.items():
        rows.append([name, "post_drift_mean", sname, f"{st.quality:.4f}",
                     f"{st.cost:.4e}", f"{st.attainment:.4f}",
                     f"{st.rt:.4f}"])
    return ScenarioResult(rows=rows, summary=summary,
                          composite=_composite(summary), windows=runs,
                          tune_s=tune_s)


def run_online(device: Device = None, seed: int = 0
               ) -> Dict[str, ScenarioResult]:
    """Both drift scenarios at the reference's sizes, on ``device`` (CUDA
    unless the caller asks for another)."""
    dev = resolve(device)
    return {name: run_scenario(name, phases, seed=seed, device=dev)
            for name, phases in SCENARIOS.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = run_online(device=args.device, seed=args.seed)
    print("scenario,window,strategy,avg_quality,avg_cost,slo_attainment,"
          "avg_rt_s")
    for res in out.values():
        for row in res.rows:
            print(",".join(str(x) for x in row))
    for name, res in out.items():
        a, s = res.summary["adaptive"], res.summary["static"]
        better = (res.composite["adaptive"] > res.composite["static"]
                  and a.attainment >= s.attainment)
        for sname, st in res.summary.items():
            print(f"online.{name}.{sname}: quality={st.quality:.4f} "
                  f"cost={st.cost:.4e} attain={st.attainment:.4f} "
                  f"rt={st.rt:.4f} composite={res.composite[sname]:.4f}")
        print(f"online.{name}.adaptive_beats_static: {better}")
        print(f"online.{name}.tune_window0_s: {res.tune_s:.3f}  refit_s: "
              + " ".join(f"{w.refit_s:.3f}" for w in res.windows))


if __name__ == "__main__":
    main()
