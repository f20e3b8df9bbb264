"""Serve trace requests with one engine on the card.

Builds a model from a seed (random weights at the config's widths), an
``LLMEngine`` over it, and answers either the first requests of the
500-request mixed trace (``workload.trace.build_trace``) or, with
``--sessions``, the 47 requests of the multi-turn session trace
(``workload.sessions.build_session_trace(SessionConfig(), seed=0)``) in
arrival order. Each prompt is tokenized word by word as the cluster server
does (``tokenize``, uncapped; prefix-stable: a later turn's tokens extend
the earlier turn's), each
request asks for its task's mean response length. Prints each request's
tokens, the QoE summary and, with the prefix cache, its counters.

    PYTHONPATH=src python -m repro_torch.serve [--model qwen3-1.7b]
        [--requests 32] [--sessions] [--device cpu] [--smoke]

It runs on CUDA unless ``--device cpu`` is given; ``--smoke`` takes the
config's reduced CPU-test size instead of its published widths. The mixed
trace's engine (``SERVE_ENGINE``) has 8 slots of 512 positions, prompts
padded to multiples of 64; the session engine (``SESSION_ENGINE``) has 8
slots of 1,088 positions (the longest session prompt, 1,007 words, plus a
budget of up to 34 fits), prompts padded to multiples of 64 and a paged
prefix cache of 16-token blocks, large enough that the run evicts nothing.
Both decode in chunks of 8 iterations.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ._device import Device, resolve, synchronize
from .configs import get
from .models import lm
from .models.config import ModelConfig
from .serving.engine import EngineConfig, LLMEngine
from .serving.scheduler import tokenize
from .workload.sessions import SessionConfig, build_session_trace
from .workload.trace import build_trace

MAX_NEW_TOKENS = 64
SERVE_ENGINE = EngineConfig(max_slots=8, max_seq=512, prefill_bucket=64)
# 1,088 blocks of 16 tokens hold all 16,974 prompt tokens of the session
# trace, so nothing is evicted
SESSION_ENGINE = EngineConfig(max_slots=8, max_seq=1088, prefill_bucket=64,
                              prefix_cache=True, block_size=16,
                              cache_blocks=1088)
CHUNK = 8            # decode iterations per read back
SEED = 0


def budget(resp_tokens_mean: float) -> int:
    """A request's max_new_tokens: its task's mean response length."""
    return int(np.clip(round(float(resp_tokens_mean)), 1, MAX_NEW_TOKENS))


@dataclasses.dataclass
class ServeRun:
    cfg: ModelConfig
    engine: LLMEngine
    prompts: Dict[int, np.ndarray]   # request id -> prompt tokens
    budgets: Dict[int, int]          # request id -> max_new_tokens
    results: Dict[int, dict]         # engine.results
    wall_s: float                    # submit of the first .. last result


def build_model(cfg: ModelConfig, device: Device = None,
                seed: int = SEED) -> lm.LM:
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm.init(cfg, gen, dev)


def run_serve(model_name: str = "qwen3-1.7b", n_requests: int = 32,
              device: Device = None, smoke: bool = False,
              model: Optional[lm.LM] = None,
              cfg: Optional[ModelConfig] = None, sessions: bool = False,
              prefix_cache: bool = True) -> ServeRun:
    """Serve the first ``n_requests`` of ``build_trace(500, seed=0)``, or
    with ``sessions`` every request of the session trace (``n_requests``
    then ignored) on ``SESSION_ENGINE``, its prefix cache on unless
    ``prefix_cache`` is False.

    ``model`` and ``cfg`` may be given (weights made elsewhere); otherwise
    the config comes from ``model_name`` and the weights from ``SEED``."""
    dev = resolve(device)
    if cfg is None:
        mod = get(model_name)
        cfg = mod.smoke() if smoke else mod.config()
    if model is None:
        model = build_model(cfg, dev)
    if sessions:
        trace = build_session_trace(SessionConfig(), seed=0)
        n_requests = trace.n_requests
        ecfg = dataclasses.replace(SESSION_ENGINE, prefix_cache=prefix_cache)
    else:
        trace = build_trace(500, seed=0)
        ecfg = SERVE_ENGINE
    engine = LLMEngine(cfg, model, ecfg, device=dev)
    prompts: Dict[int, np.ndarray] = {}
    budgets: Dict[int, int] = {}
    synchronize(dev)
    t0 = time.perf_counter()
    for rid, req in enumerate(trace.requests[:n_requests]):
        prompts[rid] = tokenize(req, cfg.vocab)
        budgets[rid] = budget(trace.resp_tokens_mean[rid])
        engine.submit(rid, prompts[rid], max_new_tokens=budgets[rid])
    results = engine.run_to_completion(chunk=CHUNK)
    synchronize(dev)
    return ServeRun(cfg=cfg, engine=engine, prompts=prompts, budgets=budgets,
                    results=results, wall_s=time.perf_counter() - t0)


def format_run(run: ServeRun) -> List[str]:
    e = run.engine
    lines = [f"{run.cfg.name}: {len(run.results)} requests, "
             f"{e.tokens_emitted + len(run.results)} tokens, "
             f"{e._steps} decode iterations in {run.wall_s:.3f} s"]
    for rid in sorted(run.results):
        r = run.results[rid]
        lines.append(f"  #{rid:3d} prompt {len(run.prompts[rid]):4d} "
                     f"ttft {r['ttft_steps']:3d} tpot {r['tpot_steps']:.2f} "
                     f"tokens {r['tokens']}")
    lines.append(f"QoE: {e.qoe_summary()}")
    if e.kv is not None:
        lines.append(f"prefix cache: {e.cache_stats()}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one)")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced CPU-test size")
    ap.add_argument("--sessions", action="store_true",
                    help="serve the multi-turn session trace, prefix cache on")
    args = ap.parse_args(argv)
    run = run_serve(args.model, args.requests, device=args.device,
                    smoke=args.smoke, sessions=args.sessions)
    print("\n".join(format_run(run)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
