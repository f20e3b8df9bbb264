"""Cluster specification (a numpy copy of ``repro.cluster.spec`` whose
array view is a NamedTuple of tensors) and the monitor the runtime router
reads (a numpy copy of ``repro.cluster.monitor``)."""
from .monitor import ClusterMonitor, NodeStats
from .spec import (MODEL_TYPE_INDEX, TASKS, ClusterArrays, ClusterSpec,
                   LinkSpec, ModelSpec, NodeSpec, disagg_testbed,
                   paper_testbed)

__all__ = ["ClusterArrays", "ClusterMonitor", "NodeStats", "ClusterSpec", "LinkSpec", "ModelSpec",
           "NodeSpec", "MODEL_TYPE_INDEX", "TASKS", "disagg_testbed",
           "paper_testbed"]
