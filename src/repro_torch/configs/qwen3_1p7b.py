"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) ff=6144 V=151936, qk_norm.

[hf:Qwen/Qwen3-8B family; hf]
"""
from ..models.config import ModelConfig

NAME = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=6144, vocab=151936, pattern=(("attn", "dense"),),
        head_dim=128, qk_norm=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
        qk_norm=True, pattern=(("attn", "dense"),))
