"""Request workloads: numpy copies of ``repro.workload``'s closed-loop
trace, its open-loop traces (``arrivals``), its QoE deadlines (``slo``),
its multi-turn session trace (``sessions``), and the generators, classifier
and features they use."""
from .tokenizer import count_tokens
from .trace import Trace, build_trace, trace_from_requests

__all__ = ["Trace", "build_trace", "trace_from_requests", "count_tokens"]
