"""Serving launcher: the paper's cloud-edge cluster with real models,
NSGA-II-tuned routing and continuous batching in fleet cohorts.

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cpu]
        [--smoke] [--requests N] [--optimize-router] [--generations G]
        [--fail-node J --fail-at I] [--max-new-tokens T]

The §V-C testbed (``paper_testbed()``: 1 cloud and 3 edge nodes, 10
routable pairs) with the reference launcher's model map: the cloud's
``gemma3:27b`` is served by stablelm-3b, and the three edge names by ONE
qwen3-1.7b model object, so the 9 edge engines form one cohort that decodes
as one batch. Weights are random, from seeds 0 and 1. ``--optimize-router``
tunes the threshold genome first (NSGA-II, pop 48 × G generations on the
64-request trace with 4 concurrent clients; survival through the dominance
kernel), else the paper's defaults route. Requests are the first N of
``build_trace(max(N, 64), seed=0)``; ``--fail-node J`` crashes node J after
submission I.

It runs on CUDA unless ``--device cpu`` is given. ``--smoke`` takes the
reduced configs and the reference launcher's engines (2 slots of 48
positions, every request T new tokens, T = 4 by default, one decode
iteration a tick). Without it the models have their published widths and
the engines ``FULL_ENGINE`` (8 slots of 128 positions, prompts padded to
multiples of 64); each request asks for its task's mean response length
(``serve.budget``) unless T is given, decoded in ticks of ``FULL_CHUNK``
iterations.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import Device, resolve, synchronize
from ..cluster.spec import paper_testbed
from ..configs import get
from ..core.fitness import EvalConfig, TraceEvaluator
from ..core.nsga2 import NSGA2, NSGA2Config
from ..core.policies.threshold import BOUNDS_HI, BOUNDS_LO, PAPER_DEFAULTS
from ..models import lm
from ..models.config import ModelConfig
from ..obs import Obs
from ..serve import budget, build_model
from ..serving import ClusterServer, EngineConfig, ServeRequest
from ..workload.trace import Trace, build_trace

CLOUD_MODEL, EDGE_MODEL = "stablelm-3b", "qwen3-1.7b"
CLOUD_NAMES = ("gemma3:27b",)
EDGE_NAMES = ("qwen2.5:1.5b-instruct", "qwen2.5-coder:1.5b-instruct",
              "qwen2.5-math:1.5b-instruct")
SMOKE_NEW_TOKENS = 4
FULL_ENGINE = EngineConfig(max_slots=8, max_seq=128, prefill_bucket=64)
FULL_CHUNK = 8
TRACE_MIN = 64      # the trace (and the tuning's) is at least this long
POP = 48
WEIGHTS = (1 / 3, 1 / 3, 1 / 3)
EVOLVE_SEED = 0

Builders = Dict[str, Tuple[ModelConfig, lm.LM]]


def build_models(device: Device = None, smoke: bool = False) -> Builders:
    """The model map: name -> (ModelConfig, LM); the three edge names share
    one LM object."""
    dev = resolve(device)
    out: Builders = {}
    for names, arch, seed in ((CLOUD_NAMES, CLOUD_MODEL, 0),
                              (EDGE_NAMES, EDGE_MODEL, 1)):
        mod = get(arch)
        cfg = mod.smoke() if smoke else mod.config()
        model = build_model(cfg, dev, seed=seed)
        out.update({n: (cfg, model) for n in names})
    return out


@dataclasses.dataclass
class Tuned:
    thresholds: np.ndarray   # (6,) the chosen threshold genome
    objectives: np.ndarray   # (3,) its (RQ, C, RT)
    seconds: float           # wall seconds of the whole NSGA-II run


def tune_thresholds(trace: Trace, generations: int,
                    device: Device = None) -> Tuned:
    """NSGA-II over the threshold genome on ``trace`` (4 concurrent
    clients), then the Eq. (1) pick with equal weights."""
    dev = resolve(device)
    ev = TraceEvaluator(trace, paper_testbed(), EvalConfig(concurrency=4),
                        device=dev)
    cfg = NSGA2Config(pop_size=POP, n_generations=generations,
                      lo=BOUNDS_LO, hi=BOUNDS_HI)
    opt = NSGA2(ev.make_fitness("threshold"), cfg, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(EVOLVE_SEED)
    state = opt.evolve_scan(gen, generations)
    g, F = opt.select_by_weights(state, WEIGHTS)
    synchronize(dev)
    return Tuned(thresholds=g.cpu().numpy().astype(np.float32),
                 objectives=F.cpu().numpy(),
                 seconds=time.perf_counter() - t0)


@dataclasses.dataclass
class LaunchRun:
    server: ClusterServer
    trace: Trace
    budgets: Dict[int, int]          # request id -> max_new_tokens
    done: Dict[int, dict]            # server.run()'s result
    chunk: int
    tuned: Optional[Tuned]
    wall_s: float                    # first submit .. the last completion


def run_launch(n_requests: int = 24, device: Device = None,
               smoke: bool = False, optimize_router: bool = False,
               generations: int = 30, fail_node: Optional[int] = None,
               fail_at: int = 5, max_new_tokens: Optional[int] = None,
               models: Optional[Builders] = None,
               thresholds: Optional[Sequence[float]] = None,
               fleet: bool = True, obs: Optional[Obs] = None) -> LaunchRun:
    """The launcher's run. ``models`` (weights made elsewhere) replaces
    ``build_models``; ``thresholds`` replaces the tuning (and the paper's
    defaults); ``obs`` is the server's telemetry bundle."""
    dev = resolve(device)
    trace = build_trace(max(n_requests, TRACE_MIN), seed=0)
    tuned = None
    if thresholds is None:
        thresholds = PAPER_DEFAULTS
        if optimize_router:
            tuned = tune_thresholds(trace, generations, dev)
            thresholds = tuned.thresholds
    if smoke:
        T = SMOKE_NEW_TOKENS if max_new_tokens is None else max_new_tokens
        ecfg, chunk = EngineConfig(max_slots=2, max_seq=48,
                                   max_new_tokens=T), 1
    else:
        ecfg, chunk = FULL_ENGINE, FULL_CHUNK
    if models is None:
        models = build_models(dev, smoke)
    srv = ClusterServer(paper_testbed(), models, thresholds, ecfg,
                        fleet=fleet, obs=obs, device=dev)
    budgets: Dict[int, int] = {}
    synchronize(dev)
    t0 = time.perf_counter()
    for i, r in enumerate(trace.requests[:n_requests]):
        budgets[i] = (max_new_tokens if max_new_tokens is not None
                      else ecfg.max_new_tokens if smoke
                      else budget(trace.resp_tokens_mean[i]))
        srv.submit(ServeRequest(request_id=i, req=r,
                                max_new_tokens=budgets[i]))
        if fail_node is not None and i == fail_at:
            srv.fail_node(fail_node)
    done = srv.run(chunk=chunk)
    synchronize(dev)
    return LaunchRun(server=srv, trace=trace, budgets=budgets, done=done,
                     chunk=chunk, tuned=tuned,
                     wall_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs and the reference's engines")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--optimize-router", action="store_true")
    ap.add_argument("--generations", type=int, default=30)
    ap.add_argument("--fail-node", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=5)
    ap.add_argument("--max-new-tokens", type=int, default=None)
    args = ap.parse_args(argv)
    run = run_launch(args.requests, device=args.device, smoke=args.smoke,
                     optimize_router=args.optimize_router,
                     generations=args.generations, fail_node=args.fail_node,
                     fail_at=args.fail_at,
                     max_new_tokens=args.max_new_tokens)
    if run.tuned is not None:
        t = run.tuned
        print(f"NSGA-II: pop {POP} x {args.generations} generations in "
              f"{t.seconds:.2f} s; thresholds "
              f"{[round(float(x), 3) for x in t.thresholds]}, objectives "
              f"(RQ, C, RT) {[float(x) for x in t.objectives]}")
    srv = run.server
    tokens = sum(len(d.get("tokens", ())) for d in run.done.values())
    print(f"served {len(run.done)} requests, {tokens} tokens, in "
          f"{run.wall_s:.2f} s ({srv.ticks} ticks of {run.chunk} decode "
          f"iterations, {tokens / run.wall_s:.1f} tokens/s on "
          f"{srv.device})")
    print("stats:", srv.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
