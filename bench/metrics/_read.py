"""The readers behind the metric files: each takes a finished run
(``harness.main.Run``) and returns the metric's value, or None where
the run holds nothing to read (no traced slice, no decode launch).

Times are the harness's host clock, in seconds after the window opened;
"in the window" means a call or token that ended at or before its close.
In a traced run the seconds the harness spends stopping its profiler are
its own, not the system's: they are taken out of every latency that spans
them and out of the window's length (``Loop.paused``).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

from . import _count as C

DECODE_KERNEL = "split_decode_kernel"


def _due(run):
    return run.loop.recs[:run.loop.n_due]


def tokens_per_s(run) -> float:
    """Output tokens that reached the host inside the window (each
    request's best copy), over the window."""
    best: Dict[int, int] = {}
    for p in run.loop.progress:
        if p.t <= run.loop.seconds and p.j1 > best.get(p.rid, 0):
            best[p.rid] = p.j1
    return sum(best.values()) / run.loop.seconds


def ttft_p95_ms(run) -> float:
    """p95 over every request due in the window of (first token on the
    host - due); a request that never got one counts as infinite."""
    lp = run.loop
    return C.percentile(
        [1e3 * (r.t_first - r.arrival.due_s
                - lp.paused(r.arrival.due_s, r.t_first))
         if r.t_first is not None else math.inf for r in _due(run)], 95)


def tpot_p95_ms(run) -> float:
    """p95 over every request due in the window of (last token - first
    token) / (tokens - 1); unfinished requests count as infinite."""
    vals = []
    for r in _due(run):
        if r.t_done is None or r.t_first is None:
            vals.append(math.inf)
        elif r.ntok > 1:
            busy = r.t_done - r.t_first - run.loop.paused(r.t_first, r.t_done)
            vals.append(1e3 * busy / (r.ntok - 1))
    return C.percentile(vals, 95)


def _spans(run, kind):
    return [s.t1 - s.t0 for s in run.loop.spans
            if s.kind == kind and s.t1 <= run.loop.seconds]


def submit_us(run) -> Optional[float]:
    """Median host time of a ``ClusterServer.submit`` in the window."""
    v = _spans(run, "submit")
    return 1e6 * statistics.median(v) if v else None


def tick_ms(run) -> Optional[float]:
    """Mean host time of a ``ClusterServer.step(chunk)`` in the window."""
    v = _spans(run, "step")
    return 1e3 * sum(v) / len(v) if v else None


def admission_ms(run) -> Optional[float]:
    """The program's counters over the window: prefill host seconds per
    admission, summed over every engine."""
    c0, c1 = run.loop.counters0, run.loop.counters1
    n = c1["admissions"] - c0["admissions"]
    if n <= 0:
        return None
    return 1e3 * (c1["prefill_seconds"] - c0["prefill_seconds"]) / n


def _work(run, kind, t0, t1) -> float:
    total = 0.0
    for p in run.loop.progress:
        if t0 < p.t <= t1:
            r = run.loop.recs[p.rid]
            total += C.copy_work(run.model_of_pair(p.pair), r.prompt_len,
                                 p.j0, p.j1, kind)
    return total


def mfu(run) -> Optional[float]:
    """Model FLOPs of every prompt and token each copy ran in the window,
    over the window, as a share of the bf16 peak."""
    lp = run.loop
    flops = _work(run, "flops", -math.inf, lp.seconds)
    return C.share(flops / (lp.seconds - lp.paused(0.0, lp.seconds)),
                   C.PEAK_BF16_FLOPS)


def decode_attn_roofline(run) -> Optional[float]:
    """In the traced slice: the decode kernel's least time (the bytes its
    live rows need at the HBM peak) over its device time."""
    if run.trace is None:
        return None
    dev = sum(v for k, v in run.trace["per_kernel"].items()
              if DECODE_KERNEL in k)
    t0, t1 = run.loop.traced
    need = _work(run, "bytes", t0, t1) / C.PEAK_HBM_BYTES
    return C.share(need, dev)


def idle_share(run) -> Optional[float]:
    """The share of the traced slice in which no device activity ran."""
    if run.trace is None:
        return None
    return C.share(run.trace["window_s"] - run.trace["busy_s"],
                   run.trace["window_s"])
