"""tick_ms: see ``_read.tick_ms``."""
from ._read import tick_ms as read  # noqa: F401
