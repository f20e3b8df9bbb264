"""Device meshes: the counterpart of ``repro.launch.mesh``.

``make_production_mesh`` builds the reference's production layouts as
``DeviceMesh``es: (16, 16) ('data', 'model') for one pod and (2, 16, 16)
('pod', 'data', 'model') for two. A ``DeviceMesh`` needs a process group of
exactly that many ranks, so outside such a cluster they are built only on
the fake process group (the dry run, the tests). ``make_host_mesh`` covers
the ranks that exist. Both need ``torch.distributed`` initialized by the
caller (its backend, address, world size and rank); neither falls back to
a mesh of its own choosing.

Axis roles:
  pod   — data parallelism across pods (only the gradient all-reduce
          crosses pod links);
  data  — data parallelism + FSDP/ZeRO-3 parameter sharding;
  model — the reference's tensor / expert parallelism; in the port the
          vocabulary, the dense FFN and the experts compute on its
          blocks (``models.tensor_parallel``), attention on whole
          weights.

The card's figures, NVIDIA H100 SXM5 80GB HBM3 at 700 W (NVIDIA's data
sheet, dense rates), for bounds and ``configs._base.make_card``:
"""
from __future__ import annotations

from typing import Optional

from .._device import Device, resolve

#: dense bf16 tensor-core rate, FLOP/s (NVIDIA H100 SXM5 80GB HBM3, 700 W)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth, bytes/s (NVIDIA H100 SXM5 80GB HBM3, 700 W)
HBM_BW = 3.35e12
#: NVLink 4 bandwidth per GPU, bytes/s, both directions (NVIDIA H100 SXM5)
NVLINK_BW = 900e9

PRODUCTION_SHAPE = {False: (16, 16), True: (2, 16, 16)}
PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def production_world(multi_pod: bool = False) -> int:
    shape = PRODUCTION_SHAPE[multi_pod]
    n = 1
    for s in shape:
        n *= s
    return n


def make_production_mesh(*, multi_pod: bool = False, device: Device = None):
    """The production mesh over the initialized process group, whose
    world size must be 256 (512 with ``multi_pod``). It runs on CUDA
    unless ``device`` names another."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve(device).type, PRODUCTION_SHAPE[multi_pod],
                            mesh_dim_names=PRODUCTION_AXES[multi_pod])


def make_host_mesh(model: int = 2, data: Optional[int] = None,
                   device: Device = None):
    """A ('data', 'model') mesh over every rank of the initialized process
    group: ``model`` ranks (at most the world size) by ``data`` (default:
    the rest). It runs on CUDA unless ``device`` names another."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type = resolve(device).type
    n = dist.get_world_size()
    model = min(model, n)
    data = data or n // model
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
