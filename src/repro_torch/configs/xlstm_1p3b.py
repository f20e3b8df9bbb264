"""xlstm-1.3b [ssm]: 48 blocks d=2048, mLSTM:sLSTM 7:1, no separate FFN
(d_ff=0; blocks carry their own projections). [arXiv:2405.04517; unverified]

mLSTM: 4 heads over a 2x up-projection (d_inner 4096, head dim 1024),
chunkwise-parallel linear-attention form. sLSTM: 4 heads at d_model with
recurrent gate matrices + 4/3x FFN. Sub-quadratic: runs the long_500k cell.
"""
from ..models.config import ModelConfig, XLSTMCfg
from ._base import make_card

NAME = "xlstm-1.3b"

_PATTERN = tuple([("mlstm", "none")] * 7 + [("slstm", "none")])


def config() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="ssm", n_layers=48, d_model=2048, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab=50304, pattern=_PATTERN,
        xlstm=XLSTMCfg(), tie_embeddings=True, supports_long_context=True,
        tp_friendly=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="ssm", n_layers=8, d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=0, vocab=256, pattern=_PATTERN,
        xlstm=XLSTMCfg(chunk=16), tie_embeddings=True,
        supports_long_context=True, tp_friendly=False)


def card():
    return make_card(NAME, config())
