"""idle_share: see ``_read.idle_share``."""
from ._read import idle_share as read  # noqa: F401
