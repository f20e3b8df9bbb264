"""Shared helpers for the architecture config modules: the counterpart of
``repro.configs._base``."""
from __future__ import annotations

import dataclasses

from ..launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelCard:
    """Registers an architecture as a routable model for the cluster layer.

    decode_tps / prefill_tps are per-chip analytic bounds (``make_card``);
    price is a Together.ai-style $/Mtok proxy scaled by active
    parameters."""
    arch: str
    params_b: float
    active_params_b: float
    model_type: str = "general"
    price_per_mtok: float = 0.0
    decode_tps: float = 0.0
    prefill_tps: float = 0.0


def make_card(name: str, cfg: ModelConfig, model_type: str = "general",
              peak_flops: float = PEAK_FLOPS_BF16,
              hbm_bw: float = HBM_BW) -> ModelCard:
    """The card of ``cfg`` on a chip of ``peak_flops`` (bf16 FLOP/s) and
    ``hbm_bw`` (bytes/s), by default the H100's (``launch.mesh``): decode
    is memory-bound at N_active bf16 bytes a token, prefill compute-bound
    at 2·N_active FLOPs a token."""
    counts = cfg.param_counts()
    nb = counts["total"] / 1e9
    na = counts["active"] / 1e9
    decode_tps = hbm_bw / max(2e9 * na, 1e6)
    prefill_tps = peak_flops / max(2e9 * na, 1e6)
    price = 0.06 + 0.09 * na  # $/Mtok, roughly Together.ai's size scaling
    return ModelCard(arch=name, params_b=nb, active_params_b=na,
                     model_type=model_type, price_per_mtok=price,
                     decode_tps=decode_tps, prefill_tps=prefill_tps)
