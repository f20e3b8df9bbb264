"""Quickstart on the port: the paper's Table II on a CUDA card.

Builds the §V-C cloud-edge testbed and the 500-request mixed trace, scores
the four baselines, evolves the threshold router with NSGA-II (pop 100 × 60
generations, survival dominance through the CUDA kernel) and prints the
Table-II-style comparison. The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
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
from .core.fitness import EvalConfig, TraceEvaluator
from .core.nsga2 import NSGA2, NSGA2Config, NSGA2State
from .core.objectives import overall_scores
from .core.policies.threshold import BOUNDS_HI, BOUNDS_LO, THRESHOLD_NAMES
from .workload.trace import build_trace

EVOLVE_SEED = 42
WEIGHTS = (1 / 3, 1 / 3, 1 / 3)


@dataclasses.dataclass
class QuickstartResult:
    rows: Dict[str, dict]        # router name -> TraceEvaluator.summarize row
    overall: Dict[str, float]    # router name -> §V-D composite score
    genome: List[float]          # the chosen threshold genome
    state: NSGA2State            # the final population
    index: int                   # the chosen genome's row in ``state``
    evolve_s: float              # wall seconds of init + all generations
    describe: str                # the testbed, as ClusterSpec.describe()


def run_quickstart(device: Device = None, n_requests: int = 500,
                   pop_size: int = 100, n_generations: int = 60,
                   seed: int = 0) -> QuickstartResult:
    dev = resolve(device)
    trace = build_trace(n_requests, seed=seed)
    cluster = paper_testbed()
    ev = TraceEvaluator(trace, cluster, EvalConfig(concurrency=1),
                        device=dev)

    rows = {}
    for name, assign in [
            ("Cloud Only", baselines.cloud_only(trace, cluster)),
            ("Edge Only", baselines.edge_only(trace, cluster)),
            ("Random Router", baselines.random_router(trace, cluster, seed)),
            ("Round Robin Router", baselines.round_robin(trace, cluster))]:
        rows[name] = ev.summarize(ev.run_assignment(assign))

    cfg = NSGA2Config(pop_size=pop_size, n_generations=n_generations,
                      lo=BOUNDS_LO, hi=BOUNDS_HI)
    opt = NSGA2(ev.make_fitness("threshold"), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(EVOLVE_SEED)
    synchronize(dev)
    t0 = time.perf_counter()
    state = opt.evolve_scan(gen, n_generations)
    synchronize(dev)
    evolve_s = time.perf_counter() - t0
    index = opt.select_index(state, WEIGHTS)
    genome = state.genomes[index]
    rows["Proposed Router"] = ev.summarize(ev.run_thresholds(genome))

    names = list(rows)
    ov = overall_scores(
        np.array([rows[n]["avg_quality"] for n in names]),
        np.array([rows[n]["avg_response_time"] for n in names]),
        np.array([rows[n]["avg_cost"] for n in names]))
    return QuickstartResult(rows=rows,
                            overall={n: float(o) for n, o in zip(names, ov)},
                            genome=[float(x) for x in genome.cpu()],
                            state=state, index=index, evolve_s=evolve_s,
                            describe=cluster.describe())


def format_table(res: QuickstartResult) -> str:
    lines = [f"{'Router':22s} {'quality↑':>9s} {'time(s)↓':>9s} "
             f"{'cost($)↓':>11s} {'overall↑':>9s}"]
    for n, r in res.rows.items():
        lines.append(f"{n:22s} {r['avg_quality']:9.4f} "
                     f"{r['avg_response_time']:9.4f} {r['avg_cost']:11.3e} "
                     f"{res.overall[n]:9.4f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    res = run_quickstart(device=args.device)
    print(res.describe)
    print(f"\nNSGA-II: {res.state.genomes.shape[0]} genomes x "
          f"{res.state.generation} generations in {res.evolve_s:.1f}s")
    print("  thresholds: " + ", ".join(
        f"{n}={v:.3f}" for n, v in zip(THRESHOLD_NAMES, res.genome)))
    print()
    print(format_table(res))


if __name__ == "__main__":
    main()
