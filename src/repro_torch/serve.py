"""Serve the mixed trace's requests with one engine on the card.

Builds a model from a seed (random weights at the config's widths), an
``LLMEngine`` over it, and answers the first requests of the 500-request
mixed trace (``workload.trace.build_trace``): each prompt is tokenized word
by word as the cluster server does, each request asks for its task's mean
response length. Prints each request's tokens and the QoE summary.

    PYTHONPATH=src python -m repro_torch.serve [--model qwen3-1.7b]
        [--requests 32] [--device cpu] [--smoke]

It runs on CUDA unless ``--device cpu`` is given; ``--smoke`` takes the
config's reduced CPU-test size instead of its published widths. The
engine has 8 slots of 512 positions, prompts padded to multiples of 64,
and decodes in chunks of 8 iterations.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ._device import Device, resolve, synchronize
from .configs import get
from .models import lm
from .models.config import ModelConfig
from .serving.engine import EngineConfig, LLMEngine
from .workload.datasets import Request
from .workload.trace import build_trace

MAX_NEW_TOKENS = 64
SERVE_ENGINE = EngineConfig(max_slots=8, max_seq=512, prefill_bucket=64)
CHUNK = 8            # decode iterations per read back
SEED = 0


def tokenize(req: Request, vocab: int,
             cap: Optional[int] = None) -> np.ndarray:
    """Deterministic, prefix-stable word-level tokens: each whitespace word
    is ``zlib.crc32(word) % vocab`` (a copy of the cluster server's
    ``_tokenize``). ``cap`` bounds the length; None keeps every word."""
    words = req.text.split()
    n = min(max(4, req.prompt_tokens), len(words))
    if cap is not None:
        n = min(n, cap)
    toks = [zlib.crc32(w.encode()) % vocab for w in words[:n]]
    if not toks:
        toks = [zlib.crc32(b"<empty>") % vocab]
    return np.asarray(toks, np.int32)


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
              cfg: Optional[ModelConfig] = None) -> ServeRun:
    """Serve the first ``n_requests`` of ``build_trace(500, seed=0)``.

    ``model`` and ``cfg`` may be given (weights made elsewhere); otherwise
    the config comes from ``model_name`` and the weights from ``SEED``."""
    dev = resolve(device)
    if cfg is None:
        mod = get(model_name)
        cfg = mod.smoke() if smoke else mod.config()
    if model is None:
        model = build_model(cfg, dev)
    trace = build_trace(500, seed=0)
    engine = LLMEngine(cfg, model, SERVE_ENGINE, device=dev)
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
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one)")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced CPU-test size")
    args = ap.parse_args(argv)
    run = run_serve(args.model, args.requests, device=args.device,
                    smoke=args.smoke)
    print("\n".join(format_run(run)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
