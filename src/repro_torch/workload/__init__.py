"""Request workloads: numpy copies of ``repro.workload``'s closed-loop trace
builder and the generators, classifier and features it uses."""
from .tokenizer import count_tokens
from .trace import Trace, build_trace, trace_from_requests

__all__ = ["Trace", "build_trace", "trace_from_requests", "count_tokens"]
