"""decode_attn_roofline: see ``_read.decode_attn_roofline``."""
from ._read import decode_attn_roofline as read  # noqa: F401
