"""Run export: Chrome-trace/Perfetto JSON and flat metric dicts.

``chrome_trace`` converts any tracer's span log into the Trace Event
Format that chrome://tracing and ui.perfetto.dev load directly:

* each span **phase** becomes a complete duration event (``"ph": "X"``)
  with ``pid`` = node (lane per node in the UI), ``tid`` = request id,
  ``ts``/``dur`` in microseconds of the emitter's clock scaled by
  ``time_unit`` (seconds for DES runs, one tick := 1 "second" for serving);
* each span **event** becomes an instant event (``"ph": "i"``) on the same
  lane, carrying its attrs;
* per-node process-name metadata events label the lanes.

``metrics_flat`` flattens a :class:`~repro_torch.obs.metrics.MetricsRegistry`
into one ``{dotted.key: float}`` dict for benchmark JSON payloads.

A copy of ``repro.obs.export`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import json
from typing import Optional

__all__ = ["chrome_trace", "metrics_flat"]


def chrome_trace(tracer, path: Optional[str] = None,
                 time_unit: float = 1.0) -> dict:
    """Export a tracer's closed (and still-open) spans.

    ``time_unit`` is seconds per clock unit of the emitter (use e.g. the
    scheduler's tick length for tick-clock tracers). Returns the document;
    writes JSON to ``path`` when given.
    """
    scale = 1e6 * time_unit          # clock units -> microseconds
    events = []
    nodes = set()
    for span in list(tracer.spans()) + list(tracer.open_spans()):
        rid = span.request_id
        for ph in span.phases:
            nodes.add(ph.node)
            events.append({
                "name": ph.name, "ph": "X", "cat": f"cat{span.category}",
                "ts": float(ph.start * scale),
                "dur": float(max(ph.duration, 0.0) * scale),
                "pid": int(ph.node), "tid": int(rid),
                "args": {"request": int(rid), "status": span.status},
            })
        for ev in span.events:
            attrs = dict(ev.attrs)
            node = int(attrs.get("node", -1))
            nodes.add(node)
            events.append({
                "name": ev.name, "ph": "i", "s": "t",
                "cat": f"cat{span.category}", "ts": float(ev.t * scale),
                "pid": node, "tid": int(rid),
                "args": {str(k): _plain(v) for k, v in attrs.items()},
            })
    for node in sorted(nodes):
        events.append({
            "name": "process_name", "ph": "M", "pid": int(node), "tid": 0,
            "args": {"name": f"node {node}" if node >= 0 else "router"},
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def _plain(v):
    """JSON-safe scalar."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def metrics_flat(registry, qs=(50, 95, 99)) -> dict:
    """Flatten a registry to ``{key: float}`` for benchmark payloads.

    Keys: ``<name>.p50`` for global series, ``<name>.node<j>.cat<c>.p95``
    for labelled ones, ``<counter>.node<j>`` / ``<counter>.total`` for
    counters and ``<gauge>`` for gauges.
    """
    out = {}
    for name, summ in registry.summary(qs=qs).items():
        for k, v in summ.items():
            out[f"{name}.{k}"] = float(v)
        for node, cat in registry.labels(name):
            p = registry.percentiles(name, qs, node=node, category=cat)
            tag = name
            if node != -1:
                tag += f".node{node}"
            if cat != -1:
                tag += f".cat{cat}"
            for k, v in p.items():
                out[f"{tag}.{k}"] = float(v)
    for name, vals in registry.counters().items():
        if vals.size == 1:
            out[f"{name}.total"] = float(vals[0])
        else:
            out[f"{name}.total"] = float(vals.sum())
            for j, v in enumerate(vals):
                out[f"{name}.node{j}"] = float(v)
    for name, vals in registry.gauges().items():
        if vals.size == 1:
            out[name] = float(vals[0])
        else:
            for j, v in enumerate(vals):
                out[f"{name}.node{j}"] = float(v)
    return out
