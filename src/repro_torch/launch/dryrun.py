"""Multi-pod dry run: the counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell it builds the step of
the cell's kind (the sharded trainer's train step, prefill, or one decode
step against an S-deep cache) at the published widths and full depth,
under ``FakeTensorMode`` on a fake process group of the production mesh's
size (256 ranks, or 512 for ``multipod``): shapes and dtypes only, no
memory allocated. As rank 0 of that mesh it records

  * train: one ``Trainer.train_step`` of the sharded trainer itself, on
    the rank's rows: the parameter and optimizer-state blocks it stores
    (the placements of ``sharding.param_specs`` and
    :func:`opt_state_specs`), the f32 gradient blocks it keeps, the most
    parameter bytes it fills into the model at once (the 'model'-parallel
    weights as the rank's blocks: attention at its heads, Mamba at its
    channels) and what the update gathers whole (nothing;
    ``Trainer.peak_bytes``); how attention's heads and Mamba's channels
    split over the ranks; the step's FLOPs (``torch.utils.flop_counter``:
    the forward, the remat recompute and the backward, the regions'
    products on the rank's blocks); its collectives as ``CommDebugMode``
    counts them, with the bytes each op writes;
  * prefill and decode: ``lm.prefill``, or one ``lm.decode_step``
    against an S-deep cache, of the sharded server itself
    (``launch.serve_mesh.ShardedServer``, the parameters stored in the
    serve placements) on the rank's rows: the parameter bytes it holds
    between steps (its resident compute blocks and the blocks it fills
    from) and the most it fills at once; the cache's bytes, the rank's
    block of every leaf, beside what the reference's ``cache_specs`` gives
    the rank, and the blocks' ranges; the heads and channels a rank holds;
    the step's FLOPs on the rank's blocks and its collectives, counted as
    for train;
  * the batch bytes of the rank's rows (split over the DP axes).

XLA's ``memory_analysis`` and ``cost_analysis`` have no torch
counterpart: the record's ``memory`` and ``cost_analysis`` are null, with
the reason. No HLO number of the reference carries over. Records go to
``--out DIR`` as ``<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out DIR
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import all_ids, get
from ..models import lm
from ..models import sharding as shard
from ..models.config import SHAPES, ModelConfig, cell_applicable
from .mesh import make_production_mesh, production_world

NO_XLA = ("XLA's compiled-memory and cost analyses have no torch "
          "counterpart; bytes are the trainer's or the server's own, FLOPs "
          "FlopCounterMode's, and activations are not counted")


def opt_state_specs(opt_name: str, shapes: Mapping[str, tuple],
                    param_specs: Mapping[str, tuple],
                    stacks: Optional[Callable] = None) -> Dict:
    """Specs of the port's optimizer state, derived from the parameters'
    (``shapes`` and ``param_specs`` keyed by parameter name), with the
    structure of ``optim``'s state: adamw's m and v take the parameter's
    spec; adamw8bit's int8 payload too, and its scales (one a block along
    the last axis) the spec without its last entry; adafactor's factored
    moments follow the leaf each updates, a stack of ``stacks`` (the
    reference's stacked leaf: a replicated leading axis) or a lone
    parameter: vr drops the last axis's entry, vc the next-to-last one,
    and a 1-D leaf's v keeps the spec. ``step`` and ``gnorm`` are
    replicated."""
    def last_drop(spec, shape):
        return tuple(spec)[:max(0, len(shape) - 1)]

    scalars = {"step": (), "gnorm": ()}
    if opt_name == "adamw":
        return {"m": dict(param_specs), "v": dict(param_specs), **scalars}
    if opt_name == "adamw8bit":
        q = {k: {"q": s, "s": last_drop(s, shapes[k])}
             for k, s in param_specs.items()}
        return {"m": q, "v": {k: dict(v) for k, v in q.items()}, **scalars}
    if opt_name == "adafactor":
        groups = stacks(list(param_specs)) if stacks is not None else {}
        grouped = {n for members in groups.values() for n in members}
        leaves = ([(k, param_specs[k], shapes[k]) for k in param_specs
                   if k not in grouped]
                  + [(k, (None,) + tuple(param_specs[k]),
                      (len(members),) + tuple(shapes[k]))
                     for k, members in groups.items()])
        f = {}
        for key, spec, shape in leaves:
            axes = tuple(spec) + (None,) * (len(shape) - len(spec))
            f[key] = ({"vr": axes[:-1], "vc": axes[:-2] + (axes[-1],)}
                      if len(shape) >= 2 else {"v": axes})
        return {"f": f, **scalars}
    raise ValueError(opt_name)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def batch_axes(cfg: ModelConfig, shape_name: str, mesh):
    """The DP axes the cell's global batch splits over (the reference's
    ``input_specs``: the whole mesh for tp_friendly=False archs)."""
    return shard.best_dp_prefix(mesh, SHAPES[shape_name].global_batch,
                                full_dp=not cfg.tp_friendly)


def input_specs(cfg: ModelConfig, shape_name: str, mesh
                ) -> Dict[str, tuple]:
    """{input: (global shape, dtype, spec)} of a cell: tokens (and labels)
    as the port's trainer and engine feed them (int64), one new token for
    decode, and the audio / vision families' stub-frontend frames or
    patches (bf16)."""
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    dp = batch_axes(cfg, shape_name, mesh)
    tok = ((B, S) if cell.kind != "decode" else (B, 1), torch.int64,
           (dp, None))
    out = {"tokens": tok}
    if cell.kind == "train":
        out["labels"] = tok
    if cell.kind != "decode" and cfg.family in ("audio", "vlm"):
        T = (cfg.encoder.n_frames if cfg.family == "audio"
             else cfg.cross_kv_tokens)
        out["frames" if cfg.family == "audio" else "patches"] = (
            (B, T, cfg.d_model), torch.bfloat16, (dp, None, None))
    return out


def _local_bytes(tree) -> int:
    """Bytes of the local blocks of a tree of DTensors."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    loc = tree.to_local()
    return loc.numel() * loc.element_size()


def _whole_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_whole_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

class _CollectiveBytes(TorchDispatchMode):
    """Adds up, by op, the bytes of the output tensors of every collective
    op it sees (``c10d`` and ``_c10d_functional``, waits left out), or of
    the buffer it writes for an op that returns none (``alltoall_base_``):
    what the step moves."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # named as CommDebugMode names the op
        name = str(func.overloadpacket).lstrip("_")
        if func.namespace in ("c10d", "_c10d_functional") \
                and "wait" not in name:
            def tensors(tree):
                return [t for t in tree_leaves(tree)
                        if isinstance(t, torch.Tensor)]
            written = tensors(out) or tensors(args[:1])
            self.bytes[name] = self.bytes.get(name, 0) + sum(
                t.nbytes for t in written)
        return out


def split_record(trainer, cfg: ModelConfig) -> dict:
    """How the regions of ``trainer`` (the sharded trainer or server)
    split attention and Mamba over 'model':
    for a rank's query heads, KV heads and Mamba channels, the least and
    the most over the ranks and rank 0's (the dry run's rank); None where
    no region splits them."""
    out = {}
    for what, leaf, unit in (("query_heads", "mixer.wq", cfg.hd),
                             ("kv_heads", "mixer.wk", cfg.hd),
                             ("mamba_channels", "mixer.D", 1)):
        sp = next((sp for k, sp in trainer.splits.items()
                   if k.endswith(leaf)), None)
        sizes = sp and [sum(b - a for a, b in r) // unit for r in sp.ranges]
        out[what] = sizes and {"min": min(sizes), "max": max(sizes),
                               "rank_0": sizes[0]}
    return out


def _collectives(comm, moved, what: str) -> dict:
    return {"count": {str(op): n for op, n in comm.get_comm_counts().items()},
            "total_count": comm.get_total_counts(), "bytes": moved.bytes,
            "what": what}


def cache_bytes(cache, mesh=None, specs=None) -> int:
    """Bytes of a cache's K/V and state leaves (kv_len, 4 bytes a row,
    left out), or of a rank's blocks of them under ``specs``."""
    leaves = {"k": cache.k, "v": cache.v, **cache.state}
    if specs is None:
        return sum(t.nbytes for t in leaves.values())
    spec = {"k": specs.k, "v": specs.v, **specs.state}
    return sum(math.prod(shard.local_shape(t.shape, mesh, spec[k]))
               * t.element_size() for k, t in leaves.items())


def _serve_record(cfg: ModelConfig, shape_name: str, mesh, batch) -> dict:
    """Run the sharded serve step (``ShardedServer``) on fake tensors with
    the rank's rows ``batch``: prefill, or one decode step against a cache
    filled to S - 1; what it holds and fills, the cache, its FLOPs and its
    collectives."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    from .serve_mesh import ShardedServer
    cell = SHAPES[shape_name]
    server = ShardedServer(cfg, mesh, "cpu")
    server.load(lm.LM(cfg, "cpu"))
    B = batch["tokens"].shape[0]
    # the global batch's rows: they fix xLSTM's state layout
    assert server.rows(torch.empty(cell.global_batch)).shape[0] == B
    cross = {k: batch[k] for k in ("frames", "patches") if k in batch}
    if cell.kind == "decode":
        cache = server.make_cache(B, cell.seq_len, kv_len=torch.full(
            (B,), cell.seq_len - 1, dtype=torch.int32))
    moved = _CollectiveBytes()
    with CommDebugMode() as comm, moved, \
            FlopCounterMode(display=False) as flops:
        if cell.kind == "prefill":
            _, cache = server.prefill(batch["tokens"], **cross)
        else:
            server.decode_step(batch["tokens"], cache)
    whole = lm.make_cache(cfg, cell.global_batch, cell.seq_len, "cpu")
    region = server.cache_region()
    return {
        "optimizer": None, "opt_state_bytes_per_rank": 0,
        "param_bytes_per_rank": server.stored_bytes(),
        "param_bytes_what": (
            "the sharded server's bytes between steps: the compute blocks "
            "of the resident weights (filled once at load: attention at "
            "the rank's query heads and the KV heads they read, the "
            "vocabulary, FFN and experts as 'model' blocks, Mamba at its "
            "channels, the rest whole) and the serve placements' blocks "
            "of the weights filled for each step"),
        "resident_params": len(server.resident),
        "filled_each_step_params": len(server.params),
        "filled_param_bytes_peak": server.peak_bytes["filled"],
        "cache_bytes_per_rank": cache_bytes(cache),
        "cache_bytes_per_rank_reference_spec": cache_bytes(
            whole, mesh, shard.cache_specs(cfg, whole, mesh)),
        "cache_what": (
            "the K/V and state leaves of the rank's rows (kv_len's 4 bytes "
            "a row left out), each the rank's block as the reference spec "
            "(sharding.cache_specs on the whole batch) lays it out: the "
            "self- and cross-attention K/V every KV head at the rank's "
            "positions of the sequence / the cross tokens, the Mamba state "
            "at its channels, the xLSTM states on the spec's axis where "
            "the 'model' ranks share the rows (whole for rows of the "
            "rank's own); cache_blocks gives each state leaf's [dim of one "
            "layer's leaf, lo, hi]"),
        "cache_blocks": {k: list(b) for k, b in lm.cache_widths(
            cfg, region, cfg.cross_kv_tokens or None).items()},
        "split_states": server.split_states,
        "split": split_record(server, cfg),
        "flops_per_rank": float(flops.get_total_flops()),
        "collectives": _collectives(
            comm, moved, f"the collectives of one ShardedServer."
            f"{'prefill' if cell.kind == 'prefill' else 'decode_step'}, "
            f"counted by CommDebugMode; bytes are each op's outputs")}


def _train_record(cfg: ModelConfig, shape_name: str, mesh, batch) -> dict:
    """Run one step of the sharded trainer (``Trainer(mesh=)``) on fake
    tensors with the rank's rows ``batch``: what it stores, what it holds
    during the step, its FLOPs and its collectives."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    from ..training.trainer import TrainConfig, Trainer
    cell = SHAPES[shape_name]
    # the dry run draws no data: a 2-token corpus keeps its tables small
    trainer = Trainer(cfg, TrainConfig(seq_len=cell.seq_len,
                                       global_batch=cell.global_batch,
                                       data_vocab=2),
                      device="cpu", mesh=mesh)
    model, state, _ = trainer.init_state(resume=False,
                                         model=lm.LM(cfg, "cpu"))
    stored = _local_bytes(trainer.params) + _local_bytes(state)
    moved = _CollectiveBytes()
    with CommDebugMode() as comm, moved, \
            FlopCounterMode(display=False) as flops:
        trainer.train_step(model, state, batch)
    peak = trainer.peak_bytes
    return {
        "optimizer": trainer.opt_name,
        "param_bytes_per_rank": _local_bytes(trainer.params),
        "opt_state_bytes_per_rank": _local_bytes(state),
        "grad_bytes_per_rank": peak["grads"],
        "filled_param_bytes_peak": peak["filled"],
        "update_group_bytes_peak": peak["update"],
        "step_bytes_per_rank": (stored + peak["grads"]
                                + max(peak["filled"], peak["update"])),
        "step_bytes_what": (
            "the trainer's stored parameter and optimizer-state blocks, "
            "its f32 gradient blocks, and the larger of the parameters "
            "filled into the model at once (embedding, head, norms, one "
            "period; the vocabulary, dense FFNs, experts, attention at "
            "the rank's query heads and the KV heads they read, and "
            "Mamba at its channels as 'model' blocks) and what the update "
            "gathers whole (nothing: every optimizer updates the blocks "
            "in place); activations and temporaries not counted"),
        "split": split_record(trainer, cfg),
        "flops_per_rank": float(flops.get_total_flops()),
        "collectives": _collectives(
            comm, moved, "the collectives of one Trainer.train_step, "
            "counted by CommDebugMode; bytes are each op's outputs")}


def build_cell(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Measure one cell on ``mesh`` (a ``DeviceMesh`` over the fake process
    group) under ``FakeTensorMode``: the record's per-rank fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    train = SHAPES[shape_name].kind == "train"
    inputs = input_specs(cfg, shape_name, mesh)
    dp = batch_axes(cfg, shape_name, mesh)
    local = {k: (shard.local_shape(shp, mesh, spec), dt)
             for k, (shp, dt, spec) in inputs.items()}
    with FakeTensorMode():
        model = lm.LM(cfg, "cpu")
        params = dict(model.named_parameters())
        batch = {k: torch.zeros(shp, dtype=dt)
                 for k, (shp, dt) in local.items()}
        rec = {"param_bytes_total": _whole_bytes(params),
               "batch_axes": list(dp) if dp else None,
               "n_dp": shard._axis_size(mesh, dp),
               "batch_local": local["tokens"][0][0],
               "batch_bytes_per_rank": sum(t.nbytes
                                           for t in batch.values())}
        rec.update((_train_record if train else _serve_record)(
            cfg, shape_name, mesh, batch))
    tokens = batch["tokens"].shape[0] * batch["tokens"].shape[1]
    rec["model_flops_per_rank"] = cfg.model_flops_per_token(train) * tokens
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir,
             force: bool = False) -> dict:
    """Measure one cell (or read its record from ``out_dir``) and write
    its JSON record there."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get(arch).config()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "family": cfg.family,
           "params_total": cfg.param_counts()["total"],
           "params_active": cfg.param_counts()["active"],
           "time": None, "status": None}
    ok, reason = cell_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=reason)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    multi_pod = mesh_kind == "multipod"
    t0 = time.time()
    if dist.is_initialized():
        raise RuntimeError("the dry run builds a fake process group of its "
                           "own; a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=production_world(multi_pod))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        per_rank = build_cell(cfg, shape_name, mesh)
        rec.update(status="ok", n_chips=production_world(multi_pod),
                   mesh_shape=shard.axis_sizes(mesh), rank=0, **per_rank,
                   memory=None, cost_analysis=None, null_because=NO_XLA,
                   time=time.time() - t0)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:],
                   time=time.time() - t0)
    finally:
        dist.destroy_process_group()
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=all_ids() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", required=True,
                    help="directory for the cells' JSON records")
    args = ap.parse_args(argv)

    archs = all_ids() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape_name, mesh_kind, args.out,
                               force=args.force)
                status = rec["status"]
                msg = rec.get("error", rec.get("reason", ""))[:100]
                t = rec.get("time")
                print(f"[{status:7s}] {arch:28s} {shape_name:12s} "
                      f"{mesh_kind:8s} {t and f'{t:6.1f}s' or '':8s} {msg}",
                      flush=True)
                failures += status == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
