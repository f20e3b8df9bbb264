"""Checkpoints: the counterpart of ``repro.checkpoint.manager``, in its
on-disk layout.

* ``step_XXXXXXXX/host_0/arrays.npz`` holds every leaf of the tree (npz keys
  are the leaf paths with ``/`` written as ``|``), and
  ``step_XXXXXXXX/manifest.json`` the step, the time, each leaf's shape and
  logical dtype, and the caller's metadata;
* **atomic commit** — a step is written to ``step_XXXXXXXX.tmp`` and renamed
  when complete, so a crash mid-write never leaves a checkpoint that
  parses; stray ``.tmp`` directories are removed at the next commit. A
  committed step is never replaced: saving it again raises
  ``FileExistsError`` before anything is written (the reference's rename
  fails onto the committed directory);
* **keep-last-k** — older steps are removed after each commit;
* **async save** — ``CheckpointManager.save`` copies the tree to the host
  first, then writes it on a background thread (at most one pending); an
  error of the writer is raised again by the next ``wait()`` or ``save``.

npz has no bfloat16, and the port does not use ``ml_dtypes``: a bf16
tensor is stored as its raw 16 bits (``uint16``), with "bfloat16" recorded
as its logical dtype, and restored to the same bits (float8_e4m3fn the same
way as ``uint8``). A tree is nested dicts, lists and tuples of tensors.

Sharded trees (the sharded trainer's DTensors): ``CheckpointManager.save``
gathers each DTensor to the whole array (a collective: all ranks call
it), and rank 0 alone copies them to the host and writes them, as
``host_0``. ``specs`` (a
tree of ``models.sharding`` specs shaped like the data) goes into the
manifest in the reference's JSON (``[None, "model"]``, a tuple of axes as a
list). ``load_checkpoint(mesh=)`` is the **elastic** restore: each array is
placed on the current mesh as a DTensor, by the given specs or else the
recorded ones, with the axes that do not divide a dimension dropped, so
the mesh need not be the one the checkpoint was written on.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed
from torch.distributed.tensor import DTensor

from ..models.sharding import (_fit, is_spec, shard, spec_from_json,
                               spec_to_json)

# logical dtype -> (torch dtype, the numpy type its bits are stored as, the
# torch type of the same width that numpy converts to)
_BITCAST = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
            "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8)}

_SEP = "/"


def _flatten(tree, prefix="", is_leaf=None):
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k],
                                f"{prefix}{_SEP}{k}" if prefix else str(k),
                                is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{_SEP}{i}", is_leaf)
    else:
        yield prefix, tree


def _flat_specs(specs) -> Dict[str, tuple]:
    """{leaf path: spec} of a specs tree (a spec is a tuple leaf)."""
    return dict(_flatten(specs, is_leaf=is_spec))


def _unflatten_into(template, flat: Dict[str, Any]):
    def walk(t, prefix=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{_SEP}{k}" if prefix else str(k))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{prefix}{_SEP}{i}")
                           for i, v in enumerate(t))
        return flat[prefix]
    return walk(template)


def _to_host(leaf) -> np.ndarray:
    """A leaf (a tensor, or anything numpy takes) as a host array; a tensor
    of a ``_BITCAST`` type as its raw bits."""
    if not torch.is_tensor(leaf):
        return np.array(leaf)
    t = leaf.detach().cpu()
    for torch_dt, bits, same_width in _BITCAST.values():
        if t.dtype == torch_dt:
            return t.view(same_width).numpy().view(bits)
    return t.numpy()


def _logical_dtype(leaf, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf):
        name = str(leaf.dtype).replace("torch.", "")
        if name in _BITCAST:
            return name
    return str(arr.dtype)


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _BITCAST:
        torch_dt, bits, same_width = _BITCAST[logical]
        signed = torch.empty((), dtype=same_width).numpy().dtype
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(signed)).view(torch_dt)
    return torch.from_numpy(np.array(arr))


def _host_copy(tree, keep: bool = True):
    """The tree with every tensor copied to the host (a new tensor); a
    DTensor gathered to its whole array first (a collective, one leaf at
    a time). With ``keep`` False the DTensors are gathered (every rank
    takes part) and dropped, and nothing is copied."""
    if isinstance(tree, dict):
        return {k: _host_copy(v, keep) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, keep) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if not keep:
        return None
    return (tree.detach().to("cpu", copy=True) if torch.is_tensor(tree)
            else tree)


def _sharded(tree) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in _flatten(tree))


def _host_leaf(leaf):
    arr = _to_host(leaf)
    return arr, _logical_dtype(leaf, arr)


def save_checkpoint(directory: str | Path, step: int, tree,
                    specs=None, metadata: Optional[dict] = None,
                    process_index: int = 0, keep: int = 3) -> Path:
    """Write one checkpoint step atomically. Returns the committed path.
    ``specs`` (a specs tree shaped like ``tree``) is recorded in the
    manifest."""
    directory = Path(directory)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    if final.exists():
        raise FileExistsError(f"checkpoint {final} is already committed")
    shard_dir = tmp / f"host_{process_index}"
    shard_dir.mkdir(parents=True, exist_ok=True)

    flat = {path: _host_leaf(leaf) for path, leaf in _flatten(tree)}
    arrays = {path: arr for path, (arr, _) in flat.items()}
    entries = {path: {"shape": list(arr.shape), "dtype": logical}
               for path, (arr, logical) in flat.items()}
    np.savez(shard_dir / "arrays.npz",
             **{k.replace("/", "|"): v for k, v in arrays.items()})

    if process_index == 0:
        manifest = {"step": step, "time": time.time(), "entries": entries,
                    "metadata": metadata or {},
                    "specs": ({k: spec_to_json(v)
                               for k, v in _flat_specs(specs).items()}
                              if specs is not None else None)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.rename(tmp, final)                        # atomic commit
        _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int):
    steps = sorted(p for p in directory.glob("step_[0-9]*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
    for p in directory.glob("*.tmp"):               # crashed writers
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    steps = sorted(int(p.name.split("_")[1])
                   for p in directory.glob("step_[0-9]*")
                   if p.is_dir() and not p.name.endswith(".tmp")
                   and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def load_checkpoint(directory: str | Path, template, step: Optional[int] = None,
                    mesh=None, specs=None):
    """Restore a checkpoint into ``template``'s structure: (tree,
    manifest). Each leaf lands on the device of the template's leaf (the
    CPU where the template's leaf is not a tensor), with its saved dtype
    and bits.

    With ``mesh`` (a ``DeviceMesh``) every leaf becomes a DTensor on it
    instead: its spec from ``specs`` (a specs tree shaped like the
    template) or else the manifest's (replicated where neither has one),
    with the axes that do not divide a dimension dropped (``_fit``)."""
    directory = Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    entries = manifest["entries"]
    devices = {path: (leaf.device if torch.is_tensor(leaf)
                      else torch.device("cpu"))
               for path, leaf in _flatten(template)}
    if mesh is not None:
        given = _flat_specs(specs) if specs is not None else {}
        recorded = manifest.get("specs") or {}
    out: Dict[str, torch.Tensor] = {}
    for host_dir in sorted(d.glob("host_*")):
        with np.load(host_dir / "arrays.npz") as z:
            for k in z.files:
                path = k.replace("|", "/")
                arr = z[k]
                logical = entries.get(path, {}).get("dtype", str(arr.dtype))
                t = _from_host(arr, logical)
                if mesh is None:
                    out[path] = t.to(devices.get(path, torch.device("cpu")))
                    continue
                spec = (given[path] if path in given else
                        spec_from_json(recorded[path]) if path in recorded
                        else ())
                spec = _fit(mesh, spec, tuple(t.shape))
                out[path] = shard(t.to(mesh.device_type), mesh, spec)
    return _unflatten_into(template, out), manifest


class CheckpointManager:
    """Async, keep-last-k manager used by the trainer."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 save_interval_steps: int = 100):
        self.directory = Path(directory)
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.directory.mkdir(parents=True, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    def save(self, step: int, tree, specs=None, metadata=None,
             blocking: bool = False):
        """Save ``tree`` as step ``step``. A tree of DTensors is gathered
        leaf by leaf on every rank (all ranks call this); rank 0 alone
        copies it to the host and writes it."""
        self.wait()
        # copy to the host *before* handing to the thread, so the step loop
        # can update its tensors in place afterwards
        writer = (not _sharded(tree)
                  or torch.distributed.get_rank() == 0)
        host_tree = _host_copy(tree, keep=writer)
        if not writer:
            return

        def work():
            save_checkpoint(self.directory, step, host_tree, specs=specs,
                            metadata=metadata, keep=self.keep)

        def background():
            try:
                work()
            except BaseException as e:      # raised again by wait()
                self._error = e

        if blocking:
            work()
        else:
            self._pending = threading.Thread(target=background, daemon=True)
            self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template, mesh=None, specs=None, step=None):
        return load_checkpoint(self.directory, template, step=step,
                               mesh=mesh, specs=specs)

    def latest_step(self):
        return latest_step(self.directory)
