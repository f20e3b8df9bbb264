"""admission_ms: see ``_read.admission_ms``."""
from ._read import admission_ms as read  # noqa: F401
