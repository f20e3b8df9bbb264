"""ttft_p95_ms.over: see ``_read.ttft_p95_ms``."""
from ._read import ttft_p95_ms as read  # noqa: F401
