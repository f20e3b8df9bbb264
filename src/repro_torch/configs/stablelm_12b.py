"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=13824 V=100352.

[hf:stabilityai/stablelm-2-12b; hf]
"""
from ..models.config import ModelConfig
from ._base import make_card

NAME = "stablelm-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=13824, vocab=100352, pattern=(("attn", "dense"),),
        rope_theta=1e4)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense", n_layers=4, d_model=160,
        n_heads=4, n_kv_heads=1, d_ff=448, vocab=512,
        pattern=(("attn", "dense"),))


def card():
    return make_card(NAME, config())
