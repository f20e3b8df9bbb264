"""tpot_p95_ms.over: see ``_read.tpot_p95_ms``."""
from ._read import tpot_p95_ms as read  # noqa: F401
