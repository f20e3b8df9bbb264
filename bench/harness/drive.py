"""The open loop: requests go to ``ClusterServer.submit`` when they are
due, whatever has finished, and ``ClusterServer.step`` runs whenever the
server holds work. Every call is a span on the host clock, and after
each call the harness reads which tokens have reached the host: every
engine's slots and new results, per copy of a request (a hedged request
runs on two engines) and per request (the most tokens of its copies).

A token reaches the host at the end of the call that produced it: the
first at its admission (inside ``submit``, or inside the ``step`` that
freed a slot), the rest at the read back that ends each decode chunk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..gen.traffic import Arrival


@dataclasses.dataclass
class Rec:
    """One request of the run."""
    arrival: Arrival
    prompt_len: int
    t_submit: float = -1.0      # host seconds after the window opened
    pair: int = -1              # the pair its first route chose
    queue: Tuple[int, ...] = ()   # node queue lengths at that decision,
    #                               counted by the harness
    monitor_queue: Tuple[int, ...] = ()   # the same, as the server's
    #                               monitor held them
    slot: Optional[Tuple[int, int]] = None   # (pair, slot) that served it
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    ntok: int = 0               # tokens that reached the host (best copy)


@dataclasses.dataclass
class Progress:
    """What a call brought to the host: (time, pair, request id, first
    token index, end token index) for each copy that advanced."""
    t: float
    pair: int
    rid: int
    j0: int
    j1: int


@dataclasses.dataclass
class Span:
    kind: str       # "submit" | "step" | "wait"
    t0: float
    t1: float


@dataclasses.dataclass
class Loop:
    """Everything the open loop recorded; times in seconds after the
    window opened."""
    recs: List[Rec]
    n_due: int                      # requests due inside the window
    seconds: float
    spans: List[Span] = dataclasses.field(default_factory=list)
    progress: List[Progress] = dataclasses.field(default_factory=list)
    lag: List[float] = dataclasses.field(default_factory=list)
    counters0: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters1: Dict[str, float] = dataclasses.field(default_factory=dict)
    traced: Optional[Tuple[float, float]] = None   # the traced slice
    t0: float = 0.0                 # the window's opening, perf_counter
    pause: Tuple[float, float] = (0.0, 0.0)   # the profiler's stop

    def paused(self, a: float, b: float) -> float:
        """Seconds of [a, b] the harness spent stopping its profiler."""
        return max(0.0, min(b, self.pause[1]) - max(a, self.pause[0]))
    follow_s: float = 0.0           # seconds past the close, following


def counters(srv) -> Dict[str, float]:
    """The program's host counters, summed over its engines."""
    engines = srv.engines.values()
    return {"prefill_seconds": sum(e.prefill_seconds for e in engines),
            "admissions": float(sum(e.admissions for e in engines))}


class Watch:
    """Reads, after each call, which tokens have reached the host, and
    counts each node's queue: the requests routed to it and not yet
    finished."""

    def __init__(self, srv, recs: List[Rec], pair_node: List[int]):
        self.srv = srv
        self.recs = recs
        self.copy: Dict[Tuple[int, int], int] = {}
        self.seen = {p: 0 for p in srv.engines}
        self.ndone = 0
        self.pair_node = pair_node
        self.queue = [0] * (max(pair_node) + 1)

    def routed(self, r: Rec) -> None:
        self.queue[self.pair_node[r.pair]] += 1

    def _advance(self, t, pair, rid, n, out: List[Progress]) -> None:
        prev = self.copy.get((pair, rid), 0)
        if n <= prev:
            return
        self.copy[(pair, rid)] = n
        out.append(Progress(t, pair, rid, prev, n))
        r = self.recs[rid]
        if n > r.ntok:
            if r.ntok == 0:
                r.t_first = t
            r.ntok = n

    def scan(self, t: float, out: List[Progress]) -> None:
        for pair, eng in self.srv.engines.items():
            for i, s in enumerate(eng.slots):
                if s.request_id is not None:
                    r = self.recs[s.request_id]
                    if r.slot is None:
                        r.slot = (pair, i)
                    self._advance(t, pair, s.request_id, len(s.generated),
                                  out)
            res = eng.results
            if len(res) > self.seen[pair]:
                for rid in list(res)[self.seen[pair]:]:
                    if rid is not None:
                        self._advance(t, pair, rid,
                                      len(res[rid]["tokens"]), out)
                self.seen[pair] = len(res)
        done = self.srv.done
        if len(done) > self.ndone:
            for rid in list(done)[self.ndone:]:
                self.recs[rid].t_done = t
                self.queue[self.pair_node[self.recs[rid].pair]] -= 1
            self.ndone = len(done)


def run(srv, recs: List[Rec], seconds: float, chunk: int,
        make_request: Callable, pair_node: List[int],
        follow_cap: float = 120.0,
        trace_at: Optional[Tuple[float, float]] = None,
        tracer=None) -> Loop:
    """Drive ``srv`` open loop for ``seconds``; then, submitting nothing
    more, step it until every request due inside the window has finished
    or ``follow_cap`` seconds have passed. ``trace_at`` (start, length)
    opens ``tracer`` (``trace.Slice``) at the first step at or after
    ``start`` and closes it after the first step that ends past its
    length. ``pair_node`` maps each pair to its node."""
    n_due = sum(r.arrival.due_s < seconds for r in recs)
    loop = Loop(recs=recs, n_due=n_due, seconds=seconds)
    watch = Watch(srv, recs, pair_node)
    i = 0
    pc = time.perf_counter
    loop.counters0 = counters(srv)
    t0 = loop.t0 = pc()
    while True:
        now = pc() - t0
        closed = now >= seconds
        if closed and loop.counters1 == {}:
            loop.counters1 = counters(srv)
        while i < n_due and recs[i].arrival.due_s <= now:
            r = recs[i]
            r.queue = tuple(watch.queue)
            r.monitor_queue = tuple(srv.monitor.queue_lengths())
            a = pc()
            srv.submit(make_request(r))
            b = pc()
            r.t_submit = a - t0
            r.pair = srv.inflight[r.arrival.index].pair
            watch.routed(r)
            loop.lag.append(r.t_submit - r.arrival.due_s)
            loop.spans.append(Span("submit", a - t0, b - t0))
            watch.scan(b - t0, loop.progress)
            i += 1
            now = pc() - t0
        if closed and i == n_due and (now >= seconds + follow_cap or all(
                r.t_done is not None for r in recs[:n_due])):
            break
        if not srv.inflight:
            until = recs[i].arrival.due_s if i < n_due else seconds
            if not closed or i < n_due:
                a = pc()
                time.sleep(max(0.0, min(until - now, 0.002)))
                loop.spans.append(Span("wait", a - t0, pc() - t0))
            continue
        if tracer is not None and trace_at is not None:
            if loop.traced is None and not tracer.open and now >= trace_at[0]:
                tracer.start()
                loop.traced = (pc() - t0, -1.0)
        a = pc()
        srv.step(chunk=chunk)
        b = pc()
        loop.spans.append(Span("step", a - t0, b - t0))
        watch.scan(b - t0, loop.progress)
        if tracer is not None and tracer.open and \
                b - t0 >= loop.traced[0] + trace_at[1]:
            tracer.stop()
            loop.traced = (loop.traced[0], tracer.t1 - t0)
            loop.pause = (tracer.t1 - t0, pc() - t0)
    if tracer is not None and tracer.open:
        tracer.stop()
        loop.traced = (loop.traced[0], tracer.t1 - t0)
    loop.follow_s = max(0.0, (pc() - t0) - seconds)
    return loop
