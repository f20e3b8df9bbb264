"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) ff=14336 V=65536,
Mamba:attention 1:7 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]

Jamba block = period 8: one attention layer (index 4), seven Mamba layers;
MoE replaces the dense MLP on every second layer. Sub-quadratic overall:
runs the long_500k cell (the 4 attention layers keep KV caches; Mamba
layers carry O(1) state).
"""
from ..models.config import MoECfg, ModelConfig, SSMCfg
from ._base import make_card

NAME = "jamba-v0.1-52b"

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 0 else "dense")
    for i in range(8))


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="hybrid", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=65536, head_dim=128,
        pattern=_PATTERN, moe=MoECfg(n_experts=16, top_k=2, d_ff=14336),
        ssm=SSMCfg(), supports_long_context=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="hybrid", n_layers=8, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
        pattern=_PATTERN, moe=MoECfg(n_experts=4, top_k=2, d_ff=256),
        ssm=SSMCfg(d_state=8, chunk=16), supports_long_context=True)


def card():
    return make_card(NAME, config())
