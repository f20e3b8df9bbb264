"""Model configuration: a copy of ``repro.models.config``.

Every architecture is expressed as a repeating *period* of blocks; each block
is (mixer, ffn) where

    mixer ∈ {"attn", "attn_bidir", "attn_cross", "cross", "mamba",
             "mlstm", "slstm"}
    ffn   ∈ {"dense", "moe", "none"}

Families:

* dense LMs            — pattern [("attn", "dense")]
* dbrx (all-MoE)       — [("attn", "moe")]
* llama4 (interleaved) — [("attn", "moe"), ("attn", "dense")]
* jamba (1:7 + MoE/2)  — period 8, attn at index 4, MoE on even indices
* xLSTM [7:1]          — 7×("mlstm", "none") + ("slstm", "none")
* llama-3.2-vision     — period 5, ("cross", "dense") at index 0
* whisper decoder      — [("attn_cross", "dense")], plus an encoder stack

The modality frontends of the audio and vision families are stubs: the model
takes precomputed frame / patch embeddings. The copy keeps every field and
the parameter accounting, so it compares equal to the reference's config
field by field, and the input shape cells of the dry run (``SHAPES``).
Plain Python: nothing of ``repro`` is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

Block = Tuple[str, str]

MIXERS = ("attn", "attn_bidir", "attn_cross", "cross", "mamba", "mlstm",
          "slstm")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden width
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    """Whisper-style encoder over a stubbed conv frontend."""
    n_layers: int
    n_frames: int = 1504          # 1500 rounded up to 32-multiple for tiling


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128              # selective-scan chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    proj_factor_m: float = 2.0    # mLSTM up-projection
    proj_factor_s: float = 1.3333  # sLSTM FFN factor
    chunk: int = 64               # mLSTM chunkwise-parallel length


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
    moe: Optional[MoECfg] = None
    encoder: Optional[EncoderCfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    cross_kv_tokens: int = 0      # VLM patch tokens / audio frames for cross
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # which serving shapes apply (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False
    # False: recurrent-dense blocks (xLSTM) gain nothing from tensor
    # parallelism — shard batch + params over the flattened (data, model)
    # axes instead (pure FSDP/ZeRO-3); see sharding.py
    tp_friendly: bool = True

    def __post_init__(self):
        assert self.family in ("dense", "moe", "audio", "ssm", "vlm", "hybrid")
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, len(self.pattern))
        for mixer, ffn in self.pattern:
            assert mixer in MIXERS and ffn in FFNS
        if any(f == "moe" for _, f in self.pattern):
            assert self.moe is not None
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

    def block_at(self, layer: int) -> Block:
        return self.pattern[layer % len(self.pattern)]

    # -- parameter accounting, as the reference counts ------------------------
    def param_counts(self) -> Dict[str, float]:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (Hq + 2 * Hkv) + Hq * hd * d
        if self.qk_norm:
            attn += 2 * hd
        dense_ffn = 3 * d * ff
        counts = {"embed": V * d, "head": 0 if self.tie_embeddings else V * d}
        total = counts["embed"] + counts["head"]
        active = total
        for li in range(self.n_layers):
            mixer, ffn = self.block_at(li)
            if mixer in ("attn", "attn_bidir", "cross"):
                m = attn
            elif mixer == "attn_cross":
                m = 2 * attn
            elif mixer == "mamba":
                di = self.ssm.expand * d
                m = (2 * d * di + di * self.ssm.d_conv
                     + di * (2 * self.ssm.d_state + 2) + di * d)
            elif mixer == "mlstm":
                di = int(self.xlstm.proj_factor_m * d)
                dh = di // self.n_heads
                # up + block-diagonal qkv + gates + down
                m = (2 * d * di + 3 * di * dh
                     + 2 * di * self.n_heads + di * d)
            elif mixer == "slstm":
                m = 4 * d * d + int(self.xlstm.proj_factor_s * d) * d * 2
            else:
                m = 0
            if ffn == "dense":
                f_tot = f_act = dense_ffn
            elif ffn == "moe":
                f_tot = (3 * d * self.moe.d_ff * self.moe.n_experts
                         + d * self.moe.n_experts)
                f_act = (3 * d * self.moe.d_ff * self.moe.top_k
                         + d * self.moe.n_experts)
            else:
                f_tot = f_act = 0
            total += m + f_tot + 2 * d     # + norms
            active += m + f_act + 2 * d
        counts["total"] = float(total)
        counts["active"] = float(active)
        if self.encoder is not None:
            enc = self.encoder.n_layers * (attn + dense_ffn + 2 * d)
            counts["encoder"] = float(enc)
            counts["total"] += enc
            counts["active"] += enc
        return counts

    def model_flops_per_token(self, train: bool = True) -> float:
        """6·N_active per trained token; 2·N_active per decoded token."""
        n = self.param_counts()["active"] - self.param_counts()["embed"]
        return (6.0 if train else 2.0) * n


# ---------------------------------------------------------------------------
# Input shape cells of the dry run: every LM arch pairs with these four
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason) — long_500k only for sub-quadratic archs."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 512k-context decode requires "
                       "sub-quadratic attention (run for SSM/hybrid only)")
    return True, ""
