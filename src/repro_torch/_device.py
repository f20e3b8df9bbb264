"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for another device. With no
card and no explicit request they raise: the port never falls back to the
CPU on its own. Resolving a device also turns TF32 off for f32 matrix
products and convolutions, so f32 stays f32 on the card.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

Device = Union[None, str, torch.device]


def resolve(device: Device = None) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def tensors(cls, fields: Mapping[str, np.ndarray], device: Device):
    """Build the NamedTuple ``cls`` from numpy fields (extra keys ignored),
    each moved to ``device`` with its dtype kept."""
    dev = resolve(device)
    return cls(**{f: torch.as_tensor(np.array(fields[f])).to(dev)
                  for f in cls._fields})


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
