"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) ff=10752 V=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]

Every layer is MoE. 16e x 3 x 6144 x 10752 x 40 = 127B expert params
+ attention/embeddings ~= 132B total, ~36B active (top-4).
"""
from ..models.config import MoECfg, ModelConfig
from ._base import make_card

NAME = "dbrx-132b"


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="moe", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab=100352, head_dim=128,
        pattern=(("attn", "moe"),),
        moe=MoECfg(n_experts=16, top_k=4, d_ff=10752), rope_theta=5e5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
        pattern=(("attn", "moe"),),
        moe=MoECfg(n_experts=4, top_k=2, d_ff=256))


def card():
    return make_card(NAME, config())
