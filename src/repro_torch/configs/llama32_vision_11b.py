"""llama-3.2-vision-11b [vlm]: 40L d=4096 32H (GQA kv=8) ff=14336 V=128256,
cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB per the assignment: input_specs provide
precomputed patch embeddings (B, 1600, 4096); each cross layer computes its
own K/V from them (cached at prefill).
"""
from ..models.config import ModelConfig
from ._base import make_card

NAME = "llama-3.2-vision-11b"

_PATTERN = tuple([("cross", "dense")] + [("attn", "dense")] * 4)


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="vlm", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=128256, pattern=_PATTERN,
        cross_kv_tokens=1600, rope_theta=5e5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="vlm", n_layers=5, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, pattern=_PATTERN,
        cross_kv_tokens=32)


def card():
    return make_card(NAME, config())
