"""Carry the routing loop's state across from numpy.

This system's "weights" are the evaluator's tables, the cluster arrays and
the optimizer state. Each converter takes ``{field: np.ndarray}`` — what
``repro``'s ``EvalTables._asdict()``, ``ClusterArrays.numpy()._asdict()``
and ``NSGA2State._asdict()`` give after ``np.asarray`` — keeps the fields the
port has, and returns the port's tensors on ``device`` with their dtypes.
Numpy in, tensors out; nothing of ``repro`` is imported.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import Device, resolve, tensors
from .cluster.spec import ClusterArrays
from .core.fitness import EvalTables
from .core.nsga2 import NSGA2State


def tables_from_numpy(d: Mapping[str, np.ndarray],
                      device: Device = None) -> EvalTables:
    return tensors(EvalTables, d, device)


def arrays_from_numpy(d: Mapping[str, np.ndarray],
                      device: Device = None) -> ClusterArrays:
    return tensors(ClusterArrays, d, device)


def state_from_numpy(d: Mapping[str, np.ndarray],
                     device: Device = None) -> NSGA2State:
    """An NSGA2State from genomes, F, F_raw, violation, rank and crowd (and
    the generation counter, 0 when absent)."""
    dev = resolve(device)
    parts = {f: torch.as_tensor(np.array(d[f])).to(dev)
             for f in NSGA2State._fields if f != "generation"}
    return NSGA2State(**parts,
                      generation=int(np.asarray(d.get("generation", 0))))
