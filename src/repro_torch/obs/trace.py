"""Request-lifecycle span tracing with an explicit clock.

One ``Span`` per request: opened at submit, closed exactly once at retire
(completed / failed / cancelled), carrying two kinds of children:

* **phases** — named intervals ``(name, start, duration, node)`` covering
  the request's wall-to-wall lifetime in the emitter's clock. The emitters
  are written so the phase durations of a completed span sum to its
  recorded completion latency (the span-conservation property,
  tests/test_obs.py).
* **events** — named instants ``(name, t, attrs)``: route-decision,
  dispatch, hedge, cancel, failure, complete, …  Accounting events
  (``dispatch``/``complete``/``failure``/``cancel``) mirror the
  ``ClusterMonitor`` counter calls one-for-one so the span log can be
  cross-checked against ``total_dispatched == completed+failed+cancelled``.

Clock discipline: the tracer NEVER reads wall time. Every mutator takes the
caller's ``now`` — simulated seconds in the DES oracles, scheduler ticks in
the serving runtime. Mixing clocks in one tracer is the caller's bug.

Closed spans live in a bounded ring buffer (``capacity`` newest spans are
kept; ``dropped`` counts evictions). ``NOOP_TRACER`` is the zero-overhead
mode: same API, every method an immediate no-op, shared singleton — hot
paths call it unconditionally and pay one Python method call per event
(benchmarks/obs_overhead.py asserts the fleet warm-throughput cost of that
is within 5%).

A copy of ``repro.obs.trace`` (pure Python; the port imports nothing of
``repro``).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional, Tuple

__all__ = ["Phase", "SpanEvent", "Span", "Tracer", "NoopTracer",
           "NOOP_TRACER"]

#: Canonical phase / event vocabulary. Emitters must not invent names
#: outside this set — the docs and the Chrome-trace colouring key off it.
PHASE_NAMES = ("upload", "queue-wait", "prefill", "kv-transfer",
               "queue-wait-decode", "decode", "download", "serve")
EVENT_NAMES = ("submit", "route-decision", "dispatch", "hedge", "cancel",
               "failure", "complete", "reroute", "handoff-start", "retire",
               "cohort-dispatch", "retry", "timeout", "shed")


class Phase(NamedTuple):
    """A named interval inside a span, in the emitter's clock."""

    name: str
    start: float
    duration: float
    node: int = -1


class SpanEvent(NamedTuple):
    """A named instant inside a span."""

    name: str
    t: float
    attrs: Tuple[Tuple[str, object], ...] = ()


class Span:
    """Lifecycle record of one request. Mutated only via its ``Tracer``."""

    __slots__ = ("request_id", "start", "category", "end", "status",
                 "phases", "events")

    def __init__(self, request_id: int, start: float, category: int = -1):
        self.request_id = request_id
        self.start = start
        self.category = category
        self.end: Optional[float] = None
        self.status = "open"
        self.phases: List[Phase] = []
        self.events: List[SpanEvent] = []

    @property
    def closed(self) -> bool:
        return self.end is not None

    def phase_total(self, names: Optional[Tuple[str, ...]] = None) -> float:
        """Sum of phase durations (optionally restricted to ``names``)."""
        return sum(p.duration for p in self.phases
                   if names is None or p.name in names)

    def key(self) -> tuple:
        """Content tuple for stream-equality comparisons (test oracle)."""
        return (self.request_id, self.start, self.category, self.end,
                self.status, tuple(self.phases), tuple(self.events))

    def rel_key(self) -> tuple:
        """Like :meth:`key` with all timestamps relative to span start —
        the equality oracle for closed-loop DES runs, where the two oracles
        assign requests to clients in different order (identical per-span
        timelines at shifted absolute offsets)."""
        t0 = self.start
        return (self.request_id, self.category,
                None if self.end is None else self.end - t0, self.status,
                tuple(Phase(p.name, p.start - t0, p.duration, p.node)
                      for p in self.phases),
                tuple(SpanEvent(e.name, e.t - t0, e.attrs)
                      for e in self.events))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"<Span rid={self.request_id} [{self.start}, {self.end}] "
                f"{self.status} phases={len(self.phases)} "
                f"events={len(self.events)}>")


class Tracer:
    """Explicit-clock span recorder with a bounded ring buffer.

    Open spans are keyed by request id; ``end`` moves a span into the
    closed ring exactly once (double-close raises — the conservation
    property is enforced, not hoped for). All methods are cheap pure-Python
    appends; nothing here touches the device or allocates per-token.
    """

    enabled = True

    def __init__(self, capacity: int = 8192):
        self._open: Dict[int, Span] = {}
        self._closed: Deque[Span] = deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped = 0

    # -- span lifecycle ------------------------------------------------------
    def begin(self, rid: int, now: float, category: int = -1) -> None:
        if rid in self._open:
            raise ValueError(f"span {rid} already open")
        self._open[rid] = Span(rid, now, category)

    def end(self, rid: int, now: float, status: str = "completed") -> None:
        span = self._open.pop(rid, None)
        if span is None:
            raise ValueError(f"span {rid} not open (double close?)")
        span.end = now
        span.status = status
        if len(self._closed) == self.capacity:
            self.dropped += 1
        self._closed.append(span)

    def set_category(self, rid: int, category: int) -> None:
        """Late category annotation (serving learns the classifier category
        only when the router decides, after the span opened at submit)."""
        span = self._open.get(rid)
        if span is not None:
            span.category = category

    # -- children ------------------------------------------------------------
    def event(self, rid: int, name: str, now: float, **attrs) -> None:
        span = self._open.get(rid)
        if span is not None:
            span.events.append(
                SpanEvent(name, now, tuple(sorted(attrs.items()))))

    def phase(self, rid: int, name: str, start: float, duration: float,
              node: int = -1) -> None:
        span = self._open.get(rid)
        if span is not None:
            span.phases.append(Phase(name, start, duration, node))

    # -- queries -------------------------------------------------------------
    def spans(self) -> List[Span]:
        """Closed spans, oldest first (bounded by ``capacity``)."""
        return list(self._closed)

    def open_spans(self) -> List[Span]:
        return list(self._open.values())

    def span(self, rid: int) -> Optional[Span]:
        """The open span for ``rid``, or the newest closed one."""
        if rid in self._open:
            return self._open[rid]
        for s in reversed(self._closed):
            if s.request_id == rid:
                return s
        return None

    def __iter__(self) -> Iterator[Span]:
        return iter(self._closed)

    def __len__(self) -> int:
        return len(self._closed)

    def clear(self) -> None:
        self._open.clear()
        self._closed.clear()
        self.dropped = 0


class NoopTracer:
    """API-compatible zero-overhead tracer: every mutator returns
    immediately, every query reports empty. Shared singleton ``NOOP_TRACER``
    is the default everywhere so call sites stay unconditional."""

    enabled = False
    capacity = 0
    dropped = 0

    def begin(self, rid, now, category=-1):
        pass

    def end(self, rid, now, status="completed"):
        pass

    def set_category(self, rid, category):
        pass

    def event(self, rid, name, now, **attrs):
        pass

    def phase(self, rid, name, start, duration, node=-1):
        pass

    def spans(self):
        return []

    def open_spans(self):
        return []

    def span(self, rid):
        return None

    def clear(self):
        pass

    def __iter__(self):
        return iter(())

    def __len__(self):
        return 0


NOOP_TRACER = NoopTracer()
