"""A configuration file's model groups read into plain dimensions, and the
benchmark's checkpoint layout: every weight's name, shape, dtype and how
the seed fills it.

The names are those of the port's parameters (``blocks.<i>.mixer.wq``,
...), so the harness can load the one set of tensors into the port and
hand the same set to the reference; the shapes, dtypes and fills are
derived here from the configuration file alone, and the harness checks
the port's modules against them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoE:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float


@dataclasses.dataclass(frozen=True)
class SSM:
    d_state: int
    d_conv: int
    expand: int
    dt_rank: int


@dataclasses.dataclass(frozen=True)
class Model:
    """One model of a configuration, as run."""
    d: int
    d_ff: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    eps: float
    rope_theta: float
    qk_norm: bool
    tie: bool
    layers: Tuple[Tuple[str, str], ...]   # (mixer, ffn) of each layer
    moe: Optional[MoE] = None
    ssm: Optional[SSM] = None

    @property
    def n_attn(self) -> int:
        return sum(m == "attn" for m, _ in self.layers)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d


def model(group: dict) -> Model:
    """A model group of a configuration file (the top level, or ``edge``)."""
    d, L = int(group["hidden_size"]), int(group["num_hidden_layers"])
    H = int(group["num_attention_heads"])
    hd = int(group.get("head_dim") or d // H)
    eps = float(group.get("rms_norm_eps", group.get("layer_norm_eps")))
    moe = ssm = None
    if "num_experts" in group:
        moe = MoE(int(group["num_experts"]), int(group["num_experts_per_tok"]),
                  int(group["intermediate_size"]),
                  float(group["moe_capacity_factor"]))
        ssm = SSM(int(group["mamba_d_state"]), int(group["mamba_d_conv"]),
                  int(group["mamba_expand"]), int(group["mamba_dt_rank"]))
        layers = tuple(
            ("attn" if i % group["attn_layer_period"]
             == group["attn_layer_offset"] else "mamba",
             "moe" if i % group["expert_layer_period"]
             == group["expert_layer_offset"] else "dense")
            for i in range(L))
    else:
        layers = (("attn", "dense"),) * L
    return Model(d=d, d_ff=int(group["intermediate_size"]), n_layers=L,
                 n_heads=H, n_kv_heads=int(group["num_key_value_heads"]),
                 head_dim=hd, vocab=int(group["vocab_size"]), eps=eps,
                 rope_theta=float(group["rope_theta"]),
                 qk_norm=bool(group.get("qk_norm", False)),
                 tie=bool(group["tie_word_embeddings"]), layers=layers,
                 moe=moe, ssm=ssm)


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: str            # "bfloat16" | "float32"
    fill: str             # "normal" | "ones" | "zeros" | "dt_bias" | "a_log"
    scale: float = 0.0    # std of a "normal" fill


def _w(name, shape, dtype="bfloat16", scale=None) -> Leaf:
    """A random weight: std 1/sqrt(d_in), d_in its next-to-last dim."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    return Leaf(name, tuple(shape), dtype, "normal", s)


def leaves(m: Model) -> List[Leaf]:
    """Every weight of ``m`` in the checkpoint layout."""
    d, hd = m.d, m.head_dim
    out = [_w("embed", (m.vocab, d), scale=0.02)]
    if not m.tie:
        out.append(_w("head", (m.vocab, d), scale=0.02))
    out.append(Leaf("final_norm.g", (d,), "float32", "ones"))
    for i, (mixer, ffn) in enumerate(m.layers):
        p = f"blocks.{i}."
        out.append(Leaf(p + "norm1.g", (d,), "float32", "ones"))
        if mixer == "attn":
            out += [_w(p + "mixer.wq", (d, m.n_heads * hd)),
                    _w(p + "mixer.wk", (d, m.n_kv_heads * hd)),
                    _w(p + "mixer.wv", (d, m.n_kv_heads * hd)),
                    _w(p + "mixer.wo", (m.n_heads * hd, d))]
            if m.qk_norm:
                out += [Leaf(p + "mixer.qnorm", (hd,), "float32", "ones"),
                        Leaf(p + "mixer.knorm", (hd,), "float32", "ones")]
        else:
            s, di = m.ssm, m.d_inner
            out += [_w(p + "mixer.in_proj", (d, 2 * di)),
                    _w(p + "mixer.conv_w", (s.d_conv, di)),
                    Leaf(p + "mixer.conv_b", (di,), "float32", "zeros"),
                    _w(p + "mixer.x_proj", (di, s.dt_rank + 2 * s.d_state)),
                    _w(p + "mixer.dt_proj_w", (s.dt_rank, di)),
                    Leaf(p + "mixer.dt_proj_b", (di,), "float32", "dt_bias"),
                    Leaf(p + "mixer.A_log", (di, s.d_state), "float32",
                         "a_log"),
                    Leaf(p + "mixer.D", (di,), "float32", "ones"),
                    _w(p + "mixer.out_proj", (di, d))]
        out.append(Leaf(p + "norm2.g", (d,), "float32", "ones"))
        if ffn == "moe":
            e = m.moe
            out += [_w(p + "ffn.router", (d, e.n_experts), "float32"),
                    _w(p + "ffn.wi", (e.n_experts, d, e.d_ff)),
                    _w(p + "ffn.wg", (e.n_experts, d, e.d_ff)),
                    _w(p + "ffn.wo", (e.n_experts, e.d_ff, d))]
        else:
            out += [_w(p + "ffn.wi", (d, m.d_ff)), _w(p + "ffn.wg", (d, m.d_ff)),
                    _w(p + "ffn.wo", (m.d_ff, d))]
    return out


# Mamba's constants as the port's init sets them (S4D-real A, the dt
# bias softplus^-1(0.01)), which the reference reads from the same tensors
DT_BIAS = -4.6
