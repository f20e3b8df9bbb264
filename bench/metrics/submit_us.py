"""submit_us: see ``_read.submit_us``."""
from ._read import submit_us as read  # noqa: F401
