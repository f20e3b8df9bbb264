"""Carry the reference's state across from numpy.

For the routing loop the "weights" are the evaluator's tables, the cluster
arrays and the optimizer state. Each converter takes ``{field: np.ndarray}``
— what ``repro``'s ``EvalTables._asdict()``, ``ClusterArrays.numpy()
._asdict()`` and ``NSGA2State._asdict()`` give after ``np.asarray`` — keeps
the fields the port has, and returns the port's tensors on ``device`` with
their dtypes. For the serving model, ``lm_params_from_numpy`` and
``cache_from_numpy`` take the reference's ``lm.init`` pytree and decode
``Cache`` with numpy leaves (``jax.tree.map(np.asarray, ...)``). Numpy in,
tensors out; nothing of ``repro`` is imported.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ._device import Device, resolve, tensors
from .cluster.spec import ClusterArrays
from .core.fitness import EvalTables
from .core.nsga2 import NSGA2State
from .models import lm
from .models.config import ModelConfig


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


def tensor_from_numpy(a: np.ndarray, device: Device = None) -> torch.Tensor:
    """A tensor with ``a``'s values and dtype; numpy's ``bfloat16`` (from
    ``ml_dtypes``, as JAX hands it out) is carried over bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve(device))


def lm_params_from_numpy(params_np: Mapping[str, Any], cfg: ModelConfig,
                         device: Device = None) -> lm.LM:
    """The port's ``LM`` from the reference's ``lm.init`` pytree: ``embed``,
    ``final_norm``, ``head`` and ``blocks[0]``, whose leaves are stacked over
    the layers (one pattern position: the dense pattern), dense weights
    (d_in, d_out). Values and dtypes are kept exactly."""
    model = lm.LM(cfg, device)
    dev = model.device

    def put(dst: torch.Tensor, src) -> None:
        src = tensor_from_numpy(src, dev)
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"shape/dtype {tuple(src.shape)} {src.dtype}, "
                             f"want {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)

    def put_norm(norm: lm.Norm, src, i=None) -> None:
        put(norm.g, src["g"] if i is None else src["g"][i])
        if norm.b is not None:
            put(norm.b, src["b"] if i is None else src["b"][i])

    put(model.embed, params_np["embed"]["table"])
    if model.head is not None:
        put(model.head, params_np["head"]["table"])
    put_norm(model.final_norm, params_np["final_norm"])
    (stacked,) = params_np["blocks"]
    for i, blk in enumerate(model.blocks):
        a, f = stacked["mixer"], stacked["ffn"]
        put_norm(blk.norm1, stacked["norm1"], i)
        put_norm(blk.norm2, stacked["norm2"], i)
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(blk.mixer, name), a[name]["w"][i])
        if cfg.qk_norm:
            put(blk.mixer.qnorm, a["qnorm"]["g"][i])
            put(blk.mixer.knorm, a["knorm"]["g"][i])
        for name in ("wi", "wg", "wo"):
            put(getattr(blk.ffn, name), f[name]["w"][i])
    return model


def cache_from_numpy(cache_np, device: Device = None) -> lm.Cache:
    """The port's ``Cache`` from the reference's dense decode ``Cache``:
    ``layer`` = ((k, v),), each (n_layers, B, Smax, Hkv, D), and ``kv_len``
    (B,)."""
    (k, v), = cache_np.layer
    return lm.Cache(k=tensor_from_numpy(k, device),
                    v=tensor_from_numpy(v, device),
                    kv_len=tensor_from_numpy(cache_np.kv_len, device)
                    .to(torch.int32))
