"""Deterministic tokenizer for request accounting.

The paper uses tiktoken purely for *token counting* (cost Eq. 3 and prompt
length features). We reproduce that role with a deterministic, dependency-free
approximation of a BPE tokenizer: whitespace words are split into sub-word
units of ~4 characters, punctuation and digits tokenize individually. On
typical English/benchmark text this lands within a few percent of cl100k_base
counts, which is all the routing features and cost metric need.

A copy of ``repro.workload.tokenizer``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import re

_WORD_RE = re.compile(r"[A-Za-z]+|\d|[^\sA-Za-z\d]")

# average characters per BPE token for alphabetic words (cl100k-ish)
_CHARS_PER_SUBWORD = 4


def count_tokens(text: str) -> int:
    """Approximate BPE token count, deterministic."""
    n = 0
    for piece in _WORD_RE.findall(text):
        if piece.isalpha():
            n += max(1, (len(piece) + _CHARS_PER_SUBWORD - 1) // _CHARS_PER_SUBWORD)
        else:
            n += 1
    return n


def text_bytes(text: str) -> int:
    return len(text.encode("utf-8"))
