"""mfu: see ``_read.mfu``."""
from ._read import mfu as read  # noqa: F401
