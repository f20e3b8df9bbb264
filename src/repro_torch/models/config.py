"""Model configuration: a copy of ``repro.models.config``'s ``ModelConfig``.

Every architecture is a repeating *period* of (mixer, ffn) blocks. The port
runs the dense pattern ``(("attn", "dense"),)`` only (``models/lm.py``
raises on any other), so this copy keeps every field, and so compares equal
to the reference's config, but not the MoE/SSM/xLSTM/encoder sub-configs
or their parameter accounting. Plain Python: nothing of ``repro`` is
imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

Block = Tuple[str, str]

MIXERS = ("attn", "attn_bidir", "attn_cross", "cross", "mamba", "mlstm",
          "slstm")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | audio | ssm | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[Block, ...]
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    activation: str = "swiglu"    # swiglu | gelu
    tie_embeddings: bool = False
    # sub-configs of the non-dense families (not ported: None here)
    moe: Optional[object] = None
    encoder: Optional[object] = None
    ssm: Optional[object] = None
    xlstm: Optional[object] = None
    cross_kv_tokens: int = 0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    supports_long_context: bool = False
    tp_friendly: bool = True

    def __post_init__(self):
        assert self.family in ("dense", "moe", "audio", "ssm", "vlm", "hybrid")
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, len(self.pattern))
        for mixer, ffn in self.pattern:
            assert mixer in MIXERS and ffn in FFNS
        assert self.n_heads % self.n_kv_heads == 0

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def param_counts(self) -> Dict[str, float]:
        """Parameters of a dense (attention + SwiGLU) model, counted as the
        reference counts them."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (Hq + 2 * Hkv) + Hq * hd * d
        if self.qk_norm:
            attn += 2 * hd
        counts = {"embed": V * d, "head": 0 if self.tie_embeddings else V * d}
        total = (counts["embed"] + counts["head"]
                 + self.n_layers * (attn + 3 * d * ff + 2 * d))
        counts["total"] = counts["active"] = float(total)
        return counts
