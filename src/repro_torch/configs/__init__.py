"""Architecture registry: copies of the ``repro.configs`` modules. Each
module exposes ``config()`` (the full published config), ``smoke()`` (a
reduced same-family config for CPU tests) and ``card()`` (its
``_base.ModelCard`` on the H100)."""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCHS: List[str] = [
    "stablelm_3b", "qwen3_4b", "stablelm_12b", "qwen3_1p7b", "dbrx_132b",
    "llama4_maverick_400b", "whisper_tiny", "xlstm_1p3b",
    "llama32_vision_11b", "jamba_52b",
]

# CLI ids (assignment spelling) -> module names, as in the reference
ALIASES: Dict[str, str] = {
    "stablelm-3b": "stablelm_3b",
    "qwen3-4b": "qwen3_4b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-1.7b": "qwen3_1p7b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-1.3b": "xlstm_1p3b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "jamba-v0.1-52b": "jamba_52b",
}


def get(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod not in ARCHS:
        raise KeyError(f"{name!r}: no such architecture; the port has "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f"{__name__}.{mod}")


def all_ids() -> List[str]:
    return list(ALIASES.keys())
