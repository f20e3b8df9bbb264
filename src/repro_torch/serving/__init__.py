"""The serving data plane: the continuous-batching engine over the dense LM."""
from .engine import EngineConfig, LLMEngine

__all__ = ["EngineConfig", "LLMEngine"]
