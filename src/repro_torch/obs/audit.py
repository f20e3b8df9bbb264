"""Routing-decision audit: one record per ``route()`` call.

Answers "why did it pick node 7?" after the fact: each record snapshots the
policy identity (name + genome), the live feasibility picture (healthy
mask, per-node queue), the per-candidate estimate rows the decision
actually consumed (upload / prefill / tpot / cost / expected hit fraction —
the score breakdown for every estimate-driven policy), the raw policy
decision, the final decision after health failover, and the failover
reason when the two differ.

Records live in a bounded ring buffer like spans; ``explain()`` renders a
human-readable account of one decision. The DES oracles log through the
same ``AuditLog`` as the runtime router, so a decision divergence between
simulation and serving shows up as a diffable record stream.

A copy of ``repro.obs.audit`` (numpy; the port imports nothing of
``repro``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["RouteAudit", "AuditLog"]


def _tup(x) -> Optional[tuple]:
    """Snapshot an array-ish as a plain tuple of floats (None passes)."""
    if x is None:
        return None
    return tuple(np.asarray(x, np.float64).ravel().round(9).tolist())


@dataclasses.dataclass(frozen=True)
class RouteAudit:
    """One routing decision, fully reconstructible."""

    index: int                     # request index / id
    now: float                     # decision timestamp (emitter's clock)
    policy: str                    # registry name of the deciding policy
    decides: str                   # "pair" | "route"
    genome: Optional[tuple]        # genome vector driving the decision
    raw_decision: int              # policy output before failover
    pair: int                      # final decode (node, model) pair
    node: int                      # final decode node
    prefill_pair: Optional[int]    # disagg prefill pair (None = colocated)
    failover: Optional[str]        # None | "node-down" | "route-endpoint-down"
    healthy: Optional[tuple]       # per-node feasibility mask at decision
    queue: Optional[tuple]         # per-node busy slots at decision
    category: int = -1             # predicted request category
    # per-candidate score breakdown (per-pair rows; None when the policy
    # never requested estimates)
    cand_up: Optional[tuple] = None
    cand_prefill: Optional[tuple] = None
    cand_tpot: Optional[tuple] = None
    cand_cost: Optional[tuple] = None
    cand_hit: Optional[tuple] = None
    est_cost: float = 0.0          # modelled $ of the chosen pair
    backup_pair: Optional[int] = None

    def key(self) -> tuple:
        """Content tuple for stream-equality comparisons."""
        return dataclasses.astuple(self)


class AuditLog:
    """Bounded ring of :class:`RouteAudit` records."""

    def __init__(self, capacity: int = 8192):
        self._records: Deque[RouteAudit] = deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped = 0

    def log(self, rec: RouteAudit) -> None:
        if len(self._records) == self.capacity:
            self.dropped += 1
        self._records.append(rec)

    def record(self, index: int, now: float, policy: str, decides: str,
               genome, raw_decision: int, pair: int, node: int,
               prefill_pair: Optional[int] = None,
               failover: Optional[str] = None, healthy=None, queue=None,
               category: int = -1, up=None, prefill=None, tpot=None,
               cost=None, hit=None, est_cost: float = 0.0,
               backup_pair: Optional[int] = None) -> RouteAudit:
        """Build + log in one call; snapshots all arrays."""
        rec = RouteAudit(
            index=int(index), now=float(now), policy=policy, decides=decides,
            genome=_tup(genome), raw_decision=int(raw_decision),
            pair=int(pair), node=int(node),
            prefill_pair=None if prefill_pair is None else int(prefill_pair),
            failover=failover, healthy=_tup(healthy), queue=_tup(queue),
            category=int(category), cand_up=_tup(up),
            cand_prefill=_tup(prefill), cand_tpot=_tup(tpot),
            cand_cost=_tup(cost), cand_hit=_tup(hit),
            est_cost=float(est_cost),
            backup_pair=None if backup_pair is None else int(backup_pair))
        self.log(rec)
        return rec

    def records(self) -> List[RouteAudit]:
        return list(self._records)

    def for_request(self, index: int) -> List[RouteAudit]:
        return [r for r in self._records if r.index == index]

    def failovers(self) -> List[RouteAudit]:
        return [r for r in self._records if r.failover is not None]

    def counts_by_policy(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._records:
            out[r.policy] = out.get(r.policy, 0) + 1
        return out

    def explain(self, index: int) -> str:
        """Human-readable account of the decision(s) for one request."""
        recs = self.for_request(index)
        if not recs:
            return f"request {index}: no audit record"
        lines = []
        for r in recs:
            lines.append(
                f"request {r.index} @ {r.now:g}: policy={r.policy} "
                f"({r.decides}) -> pair {r.pair} (node {r.node})")
            if r.prefill_pair is not None and r.prefill_pair != r.pair:
                lines.append(f"  disagg prefill on pair {r.prefill_pair}")
            if r.failover is not None:
                lines.append(f"  failover[{r.failover}]: raw decision "
                             f"{r.raw_decision} overridden")
            if r.queue is not None:
                lines.append("  queue=" +
                             str([int(q) for q in r.queue]))
            if r.cand_cost is not None:
                lines.append("  candidates (up/prefill/tpot/cost):")
                n = len(r.cand_cost)
                for p in range(n):
                    mark = " <-- chosen" if p == r.pair else ""
                    up = r.cand_up[p] if r.cand_up else float("nan")
                    pf = (r.cand_prefill[p] if r.cand_prefill
                          else float("nan"))
                    tp = r.cand_tpot[p] if r.cand_tpot else float("nan")
                    lines.append(f"    pair {p}: {up:.4g}/{pf:.4g}/"
                                 f"{tp:.4g}/${r.cand_cost[p]:.4g}{mark}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self):
        return iter(self._records)

    def clear(self) -> None:
        self._records.clear()
        self.dropped = 0
