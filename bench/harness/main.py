"""One run of one cell: set-up, the measured window, the follow past its
close, the metrics, the correctness check, the result line.

``run_cell`` does the work and returns the result as a dict, so the
control and calibration scripts can run many seeds in one process;
``main`` is the command line of ``bench/run.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..gen import traffic as T
from ..reference.tokenizer import tokenize
from . import cells, check, drive, port
from .trace import Slice, reduce

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
FOLLOW_CAP_S = 120.0    # past the close: the backlog above the knee drains in 20-40 s
TRACE_START, TRACE_LEN = 0.3, 3.0     # share of the window; seconds


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    loop: drive.Loop
    setup_s: float
    trace: Optional[dict]
    models: Dict[str, object]           # role -> reference.spec.Model
    pair_role: List[str]

    def model_of_pair(self, pair: int):
        return self.models[self.pair_role[pair]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or
    the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def _warm(conf: dict, sides, sched: List[T.Arrival], device) -> None:
    """Run every shape the cell's traffic uses once, on a server of its
    own over the same models: each engine kind's prefill at every prompt
    length the traffic holds, its decode in whole chunks and in single
    steps, and the cluster path (route, cohort dispatch, commit)."""
    tb = conf["testbed"]
    chunk, cap = tb["chunk"], tb["prompt_cap_words"]
    srv = port.build_server(conf, sides, device)
    lens = sorted({len(tokenize(a.req.text, a.req.prompt_tokens, 2, cap))
                   for a in sched})
    roles = [tb["served_by"][n] for n in _pair_models(tb)]
    rid = 10**9
    for role in ("cloud", "edge"):
        eng = srv.engines[roles.index(role)]
        for L in lens:
            eng.submit(rid, np.arange(1, L + 1, dtype=np.int32),
                       max_new_tokens=chunk + 2)
            rid += 1
        eng.run_to_completion(chunk=chunk)
    for a in sched[:4 * tb["engine"]["max_slots"]]:
        srv.submit(_request(a, rid))
        rid += 1
    srv.run(chunk=chunk)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del srv
    gc.collect()


def _pair_models(tb: dict) -> List[str]:
    return [name for n in tb["nodes"] for name in n["models"]]


def pair_node(tb: dict) -> List[int]:
    """The node of each pair, in the testbed's pair order."""
    return [j for j, n in enumerate(tb["nodes"]) for _ in n["models"]]


def _request(a: T.Arrival, rid: int):
    from repro_torch.serving import ServeRequest
    from repro_torch.workload.datasets import Request

    return ServeRequest(request_id=rid,
                        req=Request(**dataclasses.asdict(a.req)),
                        max_new_tokens=a.max_new_tokens)


def run_cell(conf: dict, traffic: dict, lim: Dict[str, float], seed: int,
             seconds: float, trace: bool, device, t_start: float,
             e2e: Dict[str, str], per_layer: Dict[str, str],
             follow_cap: float = FOLLOW_CAP_S, control: bool = False) -> dict:
    """One run; ``e2e`` and ``per_layer`` map the cell's metrics to their
    units (the second are read in a traced run, the first otherwise).
    ``control`` also reads, on the same sample, the gaps of the tokens
    the reference in float8 puts first (``_control``: quantiles of both;
    ``_raw``: every sampled token's gaps, request and slot)."""
    tb = conf["testbed"]
    sched = T.schedule(traffic, seed)
    sides = port.build_models(conf, seed, device)
    _warm(conf, sides, [a for a in sched if a.due_s < seconds], device)
    if trace:
        Slice.warm()
    srv = port.build_server(conf, sides, device)
    requests = [_request(a, a.index) for a in sched]
    recs = [drive.Rec(a, len(tokenize(a.req.text, a.req.prompt_tokens, 2,
                                      tb["prompt_cap_words"])))
            for a in sched]
    gc.collect()
    gc.freeze()         # set-up's objects out of the collector's way
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    tracer = Slice() if trace else None
    loop = drive.run(srv, recs, seconds, tb["chunk"],
                     lambda r: requests[r.arrival.index], pair_node(tb),
                     follow_cap=follow_cap,
                     trace_at=(TRACE_START * seconds, TRACE_LEN),
                     tracer=tracer)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    pair_role = [tb["served_by"][n] for n in _pair_models(tb)]
    models = {role: s.m for role, s in sides.items()}
    tr = (reduce(tracer, loop.spans, loop.t0)
          if trace and loop.traced is not None else None)
    run = Run(loop, setup_s, tr, models, pair_role)
    names = per_layer if trace else e2e
    metrics = {}
    for name, unit in names.items():
        v = cells.reader(name)(run)
        if v is not None and math.isfinite(v):
            metrics[name] = {"value": v, "unit": unit}
    # -- correctness, the server's state freed first -------------------------
    n_due = loop.n_due
    fin = check.served(srv, recs, n_due, pair_role)
    budget_wrong = sum(len(t) != recs[i].arrival.max_new_tokens
                       for i, (_, t) in fin.items())
    wrong_routes = check.routes_wrong(tb, recs, n_due)
    wrong_queues = check.queue_wrong(recs, n_due)
    vocab = {role: s.m.vocab for role, s in sides.items()}
    items = check.sample(fin, recs, seed, tb["prompt_cap_words"], vocab)
    del srv
    for s in sides.values():
        s.lm = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, out_ctl, raw = {}, {}, {}
    for role in ("cloud", "edge"):
        mine = [s for s in items if s.role == role]
        if not mine:
            continue
        g = check.gaps(sides[role].m, sides[role].W, mine, "f32", device)
        for stat, limit in lim[role].items():
            checks[f"gap_{stat}.{role}"] = (check.stat(g, stat), limit)
        if control:
            c = check.gaps(sides[role].m, sides[role].W, mine, "fp8", device)
            out_ctl[role] = {"program": check.quantiles(g),
                             "control": check.quantiles(c)}
            raw[role] = {"gap": g.gap, "control": c.gap, "rid": g.rid,
                         "slot": g.slot}
    checks["missing"] = (n_due - len(fin), 0)
    checks["budget_wrong"] = (budget_wrong, 0)
    checks["routes_wrong"] = (wrong_routes, 0)
    checks["queue_wrong"] = (wrong_queues, 0)
    correct = all(v <= limit for v, limit in checks.values())
    out = {"correct": bool(correct), "attempted": n_due,
           "failed": n_due - len(fin), "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else
                      device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim_}
                     for k, (v, lim_) in checks.items()}
    lag = sorted(loop.lag) or [0.0]
    out["_notes"] = {
        "submitted": len(loop.lag), "follow_s": loop.follow_s,
        "lag_ms_p50": 1e3 * lag[len(lag) // 2], "lag_ms_max": 1e3 * lag[-1],
        "sampled": len(items),
        "sampled_tokens": sum(len(s.tokens) for s in items),
        "sampled_roles": {r: sum(s.role == r for s in items)
                          for r in ("cloud", "edge")}}
    if control:
        out["_control"] = out_ctl
        out["_raw"] = raw
    del sides
    gc.collect()
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    conf = cells.config(bench, cell["config"])
    traffic = T.load(cell["traffic"])
    e2e = {m["name"]: m["unit"]
           for m in cells.metrics_of(bench, cell["name"], "end_to_end")}
    per = {m["name"]: m["unit"]
           for m in cells.metrics_of(bench, cell["name"], "per_layer")}
    out = run_cell(conf, traffic, cells.limits(cell["config"]), args.seed,
                   args.seconds, bool(args.trace), device, t_start, e2e, per)
    notes = out.pop("_notes")
    print(f"open loop: {notes['submitted']} submitted, generator lag p50 "
          f"{notes['lag_ms_p50']:.3f} ms, max {notes['lag_ms_max']:.3f} ms; "
          f"followed {notes['follow_s']:.3f} s past the close; sampled "
          f"{notes['sampled']} requests, {notes['sampled_tokens']} tokens "
          f"{notes['sampled_roles']}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"refusing to report: loaded {bad}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
