"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) ff=8192
V=202048, MoE 128 experts top-1, interleaved every other layer (as Maverick:
dense FFN on odd layers). [hf:meta-llama/Llama-4-Scout-17B-16E family;
unverified]

Param math: 24 MoE layers x 128e x 3 x 5120 x 8192 = 386B expert
+ 24 dense-FFN layers (3 x 5120 x 16384) + attention + 202k vocab ~= 400B
total, ~17B active (top-1 + dense path), matching the -400b-a17b name.
"""
from ..models.config import MoECfg, ModelConfig
from ._base import make_card

NAME = "llama4-maverick-400b-a17b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="moe", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=16384, vocab=202048, head_dim=128,
        pattern=(("attn", "moe"), ("attn", "dense")),
        moe=MoECfg(n_experts=128, top_k=1, d_ff=8192), rope_theta=5e5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="moe", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=320, vocab=512, head_dim=32,
        pattern=(("attn", "moe"), ("attn", "dense")),
        moe=MoECfg(n_experts=8, top_k=1, d_ff=160))


def card():
    return make_card(NAME, config())
