"""Online-learned latency/quality estimators (the port of ``repro.learn``).

The static pair tables every policy routes on are corrected by per-(node,
category) residual estimators updated from realized (prefill, TPOT,
quality) observations: in the evaluator's loop
(``EvalConfig(learned=True)``, batched over genomes by the torch twins) and
in the live ``ClusterMonitor`` (an :class:`OnlineEstimator` fed by
``RequestRouter.record``). See :mod:`repro_torch.learn.estimators`.
"""
from .estimators import (FEAT_DIM, N_CATEGORIES, N_SIGNALS,  # noqa: F401
                         LearnConfig, OnlineEstimator, corrected_rows,
                         features, init_state, observations, predict_np,
                         predict_torch, state_size, update_np, update_torch)

__all__ = ["LearnConfig", "OnlineEstimator", "state_size", "init_state",
           "features", "predict_np", "predict_torch", "update_np",
           "update_torch", "observations", "corrected_rows", "N_SIGNALS",
           "N_CATEGORIES", "FEAT_DIM"]
