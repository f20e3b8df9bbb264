"""Open-loop arrival processes for dynamic workloads (beyond-paper axis).

The paper evaluates a single static closed-loop trace (§V-C); its §IV-B.6
claim — "periodic small-scale NSGA-II re-optimization" adapting the routing
policy to workload dynamics — is only testable under an **open-loop** request
process whose statistics drift over time. This module generates such
processes:

* :func:`poisson_arrivals` — homogeneous Poisson at a fixed rate λ;
* :func:`onoff_arrivals` — bursty on/off (interrupted Poisson): alternating
  high-rate bursts and quiet periods, the classic edge-traffic pattern;
* :func:`mmpp_arrivals` — Markov-modulated Poisson over a cycle of
  :class:`PhaseSpec` phases (a deterministic-dwell MMPP, i.e. a diurnal
  profile: night / ramp / peak phases with different rates).

Each :class:`PhaseSpec` also carries a **workload-mix drift**: a category mix
over the four datasets and a prompt/response length scale, so the request
*content* drifts together with the arrival rate. :func:`build_open_loop_trace`
stitches arrivals + per-phase request generation into a ``Trace`` with
``arrival_time`` set, which the evaluator (``core.fitness`` with
``mode="open"``) replays.

A copy of ``repro.workload.arrivals`` (the port imports nothing of
``repro``); it must build the same traces bit for bit. Everything is
deterministic given ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import datasets as ds
from .trace import Trace, trace_from_requests


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One phase of a piecewise-stationary workload.

    rate        — arrival rate λ (requests/second) while the phase is active;
    duration    — dwell time in seconds before moving to the next phase;
    mix         — category mix over ``datasets.DATASETS`` order
                  (mbpp, gsm8k, squad, hellaswag); None = uniform;
    length_scale — multiplier on generated prompt/response lengths (drifting
                  prompt-length distribution).
    """

    rate: float
    duration: float
    mix: Optional[Tuple[float, float, float, float]] = None
    length_scale: float = 1.0

    def __post_init__(self):
        assert self.rate > 0 and self.duration > 0
        if self.mix is not None:
            assert len(self.mix) == len(ds.DATASETS)
            assert abs(sum(self.mix) - 1.0) < 1e-6, "mix must sum to 1"


def _exp_stream(rng: np.random.Generator, rate: float, t0: float, t1: float,
                limit: Optional[int] = None) -> List[float]:
    """Poisson arrival instants in [t0, t1) at rate ``rate``; at most
    ``limit`` of them (so an effectively-infinite dwell stays O(limit))."""
    out = []
    t = t0
    while limit is None or len(out) < limit:
        t += rng.exponential(1.0 / rate)
        if t >= t1:
            break
        out.append(t)
    return out


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """(n,) sorted float32 timestamps of a homogeneous Poisson process."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.cumsum(gaps).astype(np.float32)


def onoff_arrivals(n: int, rate_on: float, rate_off: float, on_s: float,
                   off_s: float, seed: int = 0) -> np.ndarray:
    """(n,) timestamps of a bursty on/off (interrupted Poisson) process."""
    phases = (PhaseSpec(rate=rate_on, duration=on_s),
              PhaseSpec(rate=rate_off, duration=off_s))
    times, _ = mmpp_arrivals(n, phases, seed=seed)
    return times


def mmpp_arrivals(n: int, phases: Sequence[PhaseSpec], seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic-dwell MMPP: cycle through ``phases`` until n arrivals.

    Returns (timestamps (n,) float32 sorted, phase_id (n,) int32) — the phase
    each request was generated in, which drives the per-phase workload mix.
    """
    assert phases, "need at least one phase"
    rng = np.random.default_rng(np.random.SeedSequence([seed, 13]))
    times: List[float] = []
    ids: List[int] = []
    t = 0.0
    k = 0
    while len(times) < n:
        ph = phases[k % len(phases)]
        seg = _exp_stream(rng, ph.rate, t, t + ph.duration,
                          limit=n - len(times))
        times.extend(seg)
        ids.extend([k % len(phases)] * len(seg))
        t += ph.duration
        k += 1
    return (np.asarray(times[:n], np.float32),
            np.asarray(ids[:n], np.int32))


def _scale_request(r: ds.Request, scale: float) -> ds.Request:
    """Apply a prompt/response length scale to a generated request.

    Text is repeated (never truncated mid-token) so the tokenizer-derived
    observables stay consistent with the content the classifier sees.
    """
    if abs(scale - 1.0) < 1e-9:
        return r
    reps = max(1, int(round(scale)))
    text = " ".join([r.text] * reps) if reps > 1 else r.text
    return dataclasses.replace(
        r, text=text,
        prompt_tokens=max(1, int(round(r.prompt_tokens * scale))),
        query_bytes=max(1, int(round(r.query_bytes * scale))),
        resp_tokens_mean=float(r.resp_tokens_mean * scale),
        sentence_count=max(1, int(round(r.sentence_count * scale))))


def build_open_loop_trace(n_requests: int, phases: Sequence[PhaseSpec],
                          seed: int = 0) -> Trace:
    """Open-loop trace whose mix/lengths drift with the MMPP phase cycle.

    Each arrival draws its dataset from the active phase's category mix and
    scales its lengths by the phase's ``length_scale``; the returned trace
    carries ``arrival_time`` so the evaluator replays it open-loop.
    """
    times, phase_id = mmpp_arrivals(n_requests, phases, seed=seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17]))
    # oversized per-dataset pools so any mix can be satisfied
    pools = {name: ds.generate(name, n_requests, seed=seed)
             for name in ds.DATASETS}
    cursors = {name: 0 for name in ds.DATASETS}
    uniform = np.full(len(ds.DATASETS), 1.0 / len(ds.DATASETS))

    reqs: List[ds.Request] = []
    for i in range(n_requests):
        ph = phases[int(phase_id[i])]
        mix = uniform if ph.mix is None else np.asarray(ph.mix, np.float64)
        name = ds.DATASETS[int(rng.choice(len(ds.DATASETS), p=mix))]
        reqs.append(_scale_request(pools[name][cursors[name]],
                                   ph.length_scale))
        cursors[name] += 1
    trace = trace_from_requests(reqs, seed=seed, arrival_time=times)
    trace.phase_id = phase_id
    return trace
