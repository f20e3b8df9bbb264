"""Cluster specification: a numpy copy of ``repro.cluster.spec`` whose
array view is a NamedTuple of tensors."""
from .spec import (MODEL_TYPE_INDEX, TASKS, ClusterArrays, ClusterSpec,
                   LinkSpec, ModelSpec, NodeSpec, paper_testbed)

__all__ = ["ClusterArrays", "ClusterSpec", "LinkSpec", "ModelSpec",
           "NodeSpec", "MODEL_TYPE_INDEX", "TASKS", "paper_testbed"]
