"""Policy matrix: every registered routing policy on one shared workload, on
the port: the counterpart of ``benchmarks/policy_matrix.py``.

The registry (``core.policies``) makes the policy the unit of extension;
the matrix enumerates ``list_policies()`` at run time, fits each policy
with NSGA-II under a configuration derived from its own ``GenomeSpec``
(``NSGA2Config.from_policy``, pop 16 × 12 generations, the 4-objective QoE
fitness, survival through the dominance kernel on the card), picks a genome
by the Eq. (1)-style weights, and replays the hand defaults (when the spec
has any) and the tuned genome on one open-loop multi-turn session trace
(192 requests, SLO deadlines) with the prefix-cache model on. Route-valued
policies (``disagg``) run under the disaggregated model.

Per (policy, variant) it reports quality, cost, mean RT, RT p50/p95/p99 and
TTFT p99 from the shared log-bucket histogram, mean TTFT, SLO attainment,
the cache-hit fraction, the NSGA-II fit's wall seconds, and SLO attainment
under an unannounced cloud straggler (node 0 three times slower), once on
the static priors and once with the online estimators correcting the
estimate rows (``EvalConfig(learned=True)``).

    PYTHONPATH=src python -m repro_torch.policy_matrix [--device cpu] [--smoke]

``--smoke`` runs the reference's smoke sizes (48 requests, pop 8 × 4
generations). The rows are printed and returned; nothing is written.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ._device import Device, resolve, synchronize
from .cluster.spec import ClusterSpec, paper_testbed
from .core.fitness import EvalConfig, EvalResult, TraceEvaluator
from .core.nsga2 import NSGA2, NSGA2Config
from .core.policies import get_policy, list_policies
from .faults import FaultSchedule, Straggler
from .learn import LearnConfig
from .obs.metrics import Histogram
from .workload.sessions import SessionConfig, build_session_trace
from .workload.slo import attach_slos
from .workload.trace import Trace

N_REQUESTS = 192
POP, GENS = 16, 12
SMOKE_REQUESTS, SMOKE_POP, SMOKE_GENS = 48, 8, 4
TIGHTNESS = 2.0
# Eq. (1)-style selection weights over (RQ, C, RT, V) for the NSGA pick
WEIGHTS = (0.25, 0.30, 0.30, 0.15)
# the unannounced straggler: the cloud node 3x slower than its static table
STRAGGLER = FaultSchedule(stragglers=(Straggler(0, 0.0, 1e9, 3.0),))

#: evaluator configurations, keyed (decision space, regime)
SPACES = ("pair", "route")
REGIMES = ("clean", "straggler_static", "straggler_learned")

COLUMNS = ("policy", "variant", "avg_quality", "avg_cost", "avg_rt_s",
           "rt_p50_s", "rt_p95_s", "rt_p99_s", "avg_ttft_s", "ttft_p99_s",
           "slo_attainment", "cache_hit_frac", "attain_straggler_static",
           "attain_straggler_learned", "nsga2_fit_s")


@dataclasses.dataclass
class MatrixRow:
    policy: str
    variant: str                # "tuned" | "default"
    genome: np.ndarray
    avg_quality: float
    avg_cost: float
    avg_rt_s: float
    rt_p50_s: float
    rt_p95_s: float
    rt_p99_s: float
    avg_ttft_s: float
    ttft_p99_s: float
    slo_attainment: float
    cache_hit_frac: float
    attain_straggler_static: float
    attain_straggler_learned: float
    nsga2_fit_s: float
    #: the per-request results behind the row, per regime, as a
    #: population of one (1, I) on the evaluators' device
    results: Dict[str, EvalResult] = dataclasses.field(default_factory=dict,
                                                       repr=False)

    def cells(self) -> list:
        return [getattr(self, c) for c in COLUMNS]


def workload(n_requests: int, seed: int = 0) -> Trace:
    """The shared open-loop multi-turn session trace with SLO deadlines."""
    cfg = SessionConfig(n_sessions=max(2, n_requests // 3), mean_turns=3.0,
                        session_rate=1.5, think_time_s=3.0)
    tr = build_session_trace(cfg, seed=seed, n_requests=n_requests)
    attach_slos(tr, tightness=TIGHTNESS, seed=seed)
    return tr


def eval_config(space: str, regime: str) -> Tuple[EvalConfig,
                                                  Optional[FaultSchedule]]:
    """The evaluator configuration and fault schedule of one matrix cell."""
    cfg = EvalConfig(mode="open", prefix_cache=True,
                     disaggregated=space == "route",
                     learned=regime == "straggler_learned",
                     learner=LearnConfig())
    return cfg, (None if regime == "clean" else STRAGGLER)


def evaluators(trace: Trace, cluster: ClusterSpec, device: Device
               ) -> Dict[Tuple[str, str], TraceEvaluator]:
    """The six evaluators of the matrix, all bucketed to a power of two."""
    out = {}
    for space in SPACES:
        for regime in REGIMES:
            cfg, faults = eval_config(space, regime)
            out[space, regime] = TraceEvaluator(trace, cluster, cfg,
                                                bucket="pow2", faults=faults,
                                                device=device)
    return out


def space_of(policy: str) -> str:
    return "route" if get_policy(policy).decides == "route" else "pair"


def fit(ev: TraceEvaluator, policy: str, pop: int, gens: int, seed: int,
        device: torch.device) -> Tuple[np.ndarray, float]:
    """NSGA-II on the QoE fitness, the weighted pick, and the fit's wall
    seconds."""
    pol = get_policy(policy)
    if pol.genome_spec.per_request:
        cfg = NSGA2Config.from_policy(pol, pop_size=pop, n_generations=gens,
                                      genome_length=ev.n_valid,
                                      n_choices=ev.cluster.n_pairs)
    else:
        cfg = NSGA2Config.from_policy(pol, pop_size=pop, n_generations=gens)
    opt = NSGA2(ev.make_fitness(policy, objectives="qoe"), cfg,
                device=device)
    synchronize(device)
    t0 = time.perf_counter()
    state = opt.evolve_scan(torch.Generator(device=device).manual_seed(seed),
                            gens)
    synchronize(device)
    fit_s = time.perf_counter() - t0
    genome, _ = opt.select_by_weights(state, WEIGHTS)
    return genome.cpu().numpy(), fit_s


def replay(evs: Dict[Tuple[str, str], TraceEvaluator], policy: str,
           variant: str, genome: np.ndarray, fit_s: float) -> MatrixRow:
    """One genome on the clean evaluator of its decision space, with tail
    latencies off the log-bucket histogram, and its SLO attainment under
    the straggler on static priors and with the learned estimators."""
    space = space_of(policy)
    results = {regime: evs[space, regime].run_population(policy, genome[None])
               for regime in REGIMES}
    summary = {regime: evs[space, regime].summarize(res.row(0))
               for regime, res in results.items()}
    s, res = summary["clean"], results["clean"]
    h_rt, h_tt = Histogram(), Histogram()
    h_rt.observe(res.rt[0].cpu().numpy().astype(np.float64))
    h_tt.observe(res.ttft[0].cpu().numpy().astype(np.float64))
    rt_p, tt_p = h_rt.percentiles(), h_tt.percentiles()
    return MatrixRow(
        policy=policy, variant=variant, genome=genome,
        avg_quality=s["avg_quality"], avg_cost=s["avg_cost"],
        avg_rt_s=s["avg_response_time"], rt_p50_s=rt_p["p50"],
        rt_p95_s=rt_p["p95"], rt_p99_s=rt_p["p99"], avg_ttft_s=s["avg_ttft"],
        ttft_p99_s=tt_p["p99"], slo_attainment=s["slo_attainment"],
        cache_hit_frac=s["cache_hit_frac"],
        attain_straggler_static=summary["straggler_static"][
            "slo_attainment"],
        attain_straggler_learned=summary["straggler_learned"][
            "slo_attainment"],
        nsga2_fit_s=fit_s, results=results)


def run(device: Device = None, seed: int = 0, smoke: bool = False
        ) -> List[MatrixRow]:
    """Fit every registered policy and replay its default and tuned
    genomes; prints the rows and returns them."""
    dev = resolve(device)
    n, pop, gens = ((SMOKE_REQUESTS, SMOKE_POP, SMOKE_GENS) if smoke
                    else (N_REQUESTS, POP, GENS))
    cluster = paper_testbed()
    trace = workload(n, seed)
    evs = evaluators(trace, cluster, dev)
    rows = []
    for name in list_policies():
        genome, fit_s = fit(evs[space_of(name), "clean"], name, pop, gens,
                            seed, dev)
        variants = {"tuned": genome}
        defaults = get_policy(name).genome_spec.defaults
        if defaults is not None:
            variants["default"] = np.asarray(defaults)
        for variant, g in variants.items():
            rows.append(replay(evs, name, variant, g, fit_s))
    # the registry contract: every registered policy produced a tuned row
    missing = [p for p in list_policies()
               if not any(r.policy == p and r.variant == "tuned"
                          for r in rows)]
    assert not missing, f"policy matrix missed registered policies: {missing}"
    print(",".join(COLUMNS), flush=True)
    for r in rows:
        print(",".join(c if isinstance(c, str) else f"{c:.6g}"
                       for c in r.cells()), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run here)")
    ap.add_argument("--smoke", action="store_true",
                    help="48 requests, pop 8 x 4 generations")
    args = ap.parse_args(argv)
    run(device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
