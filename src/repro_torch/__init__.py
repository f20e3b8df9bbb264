"""PyTorch/CUDA port of the cloud-edge LLM request router.

The package mirrors ``repro`` module for module (``repro_torch/core/fitness.py``
is the counterpart of ``repro/core/fitness.py``) and imports neither JAX nor
``repro``: the numpy modules it needs are copies kept here. Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
__all__ = ["cluster", "configs", "convert", "core", "faults", "kernels",
           "learn", "models", "obs", "online", "policy_matrix", "quickstart",
           "serve", "serving", "workload"]
