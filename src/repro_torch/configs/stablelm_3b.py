"""stablelm-3b [dense]: 32L d=2560 32H (kv=32) ff=6912 V=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified] Full multi-head attention
(kv=32 == heads), SwiGLU, RMSNorm, untied head.
"""
from ..models.config import ModelConfig
from ._base import make_card

NAME = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, d_ff=6912, vocab=50304, pattern=(("attn", "dense"),),
        rope_theta=1e4)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=352, vocab=512,
        pattern=(("attn", "dense"),))


def card():
    return make_card(NAME, config())
