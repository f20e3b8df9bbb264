"""Architecture registry: copies of the ``repro.configs`` modules the port
runs. Each module exposes ``config()`` (the full published config) and
``smoke()`` (a reduced same-family config for CPU tests)."""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCHS: List[str] = ["stablelm_3b", "qwen3_1p7b"]

# CLI ids (assignment spelling) -> module names, as in the reference
ALIASES: Dict[str, str] = {
    "stablelm-3b": "stablelm_3b",
    "qwen3-1.7b": "qwen3_1p7b",
}


def get(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod not in ARCHS:
        raise KeyError(f"{name!r}: the port has configs for "
                       f"{sorted(ALIASES)} only")
    return importlib.import_module(f"{__name__}.{mod}")

