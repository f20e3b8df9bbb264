"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) ff=9728 V=151936, qk_norm.

[hf:Qwen/Qwen3-8B family; hf] Qwen3 uses head_dim=128 (q_dim 4096 != d_model)
and per-head RMS q/k norms.
"""
from ..models.config import ModelConfig
from ._base import make_card

NAME = "qwen3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense", n_layers=36, d_model=2560, n_heads=32,
        n_kv_heads=8, d_ff=9728, vocab=151936, pattern=(("attn", "dense"),),
        head_dim=128, qk_norm=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
        qk_norm=True, pattern=(("attn", "dense"),))


def card():
    return make_card(NAME, config())
