"""tokens_per_s: see ``_read.tokens_per_s``."""
from ._read import tokens_per_s as read  # noqa: F401
