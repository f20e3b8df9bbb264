"""The server's word tokenizer, frozen: each whitespace word of a prompt
hashed by ``zlib.crc32`` into the model's vocabulary, at most
``max(4, prompt_tokens)`` words and at most ``cap`` of them (the server's
prompt cap); an empty prompt is one placeholder token. The reference
derives every prompt's tokens from its text with this copy."""
from __future__ import annotations

import zlib
from typing import List, Optional


def tokenize(text: str, prompt_tokens: int, vocab: int,
             cap: Optional[int]) -> List[int]:
    words = text.split()
    n = min(max(4, prompt_tokens), len(words))
    if cap is not None:
        n = min(n, cap)
    toks = [zlib.crc32(w.encode()) % vocab for w in words[:n]]
    return toks or [zlib.crc32(b"<empty>") % vocab]
