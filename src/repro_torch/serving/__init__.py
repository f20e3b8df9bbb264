"""The serving data plane: the continuous-batching engine over the dense LM,
fleet cohorts that decode as one batch, and the cluster server that routes
requests to the engines of a cloud-edge cluster."""
from .engine import EngineConfig, LLMEngine
from .fleet import Cohort, FleetState, build_cohorts
from .kvcache import (BlockPool, FleetKVPools, PagedKVCache, PagedKVStore,
                      RadixIndex)
from .scheduler import ClusterServer, ResilienceConfig, ServeRequest

__all__ = ["LLMEngine", "EngineConfig", "ClusterServer", "ServeRequest",
           "ResilienceConfig",
           "BlockPool", "RadixIndex", "PagedKVCache", "PagedKVStore",
           "Cohort", "FleetState", "FleetKVPools", "build_cohorts"]
