"""Rank bodies of the port's multi-rank CPU runs (gloo), for
``tests/test_torch_mesh_train.py``. Nothing here imports JAX: each rank is
a process of its own, started by ``launch`` with

    python tests/torch_mesh_workers.py JOB RANK WORLD RENDEZVOUS OUT

It joins a gloo process group through a ``file://`` rendezvous (with a
timeout, so that a dead rank fails the run instead of hanging it), runs
``JOB`` and writes what it found to ``OUT/<job>_<rank>.pt``.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT_S = 120
TRAIN_ARCH = "stablelm-3b"
TRAIN = dict(seq_len=16, global_batch=4, steps=1, log_every=1,
             optimizer="adamw")


def launch(job: str, world: int, tmp: Path) -> list:
    """Run ``job`` on ``world`` ranks, each a process of its own; the list
    of what each rank wrote. Raises if a rank fails or outlasts
    ``TIMEOUT_S``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"
    rdv = tmp / f"{job}.rdv"
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(rdv),
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{job} rank {r} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
    return [torch.load(tmp / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)]


def _train_cfg():
    from repro_torch.configs import get
    return dataclasses.replace(get(TRAIN_ARCH).smoke(), dtype="float32")


def _model(cfg, seed=0):
    from repro_torch.models import lm
    return lm.init(cfg, torch.Generator().manual_seed(seed), "cpu")


def _empty(model) -> bool:
    """Whether no parameter of ``model`` holds storage."""
    return all(p.untyped_storage().nbytes() == 0 for p in model.parameters())


def _gathered(trainer, model):
    """{name: whole parameter} of ``model`` filled from the stored
    blocks."""
    return {k: p.detach().clone()
            for k, p in trainer.gather_model(model).named_parameters()}


def _train(mesh_shape, ckpt_dir=None):
    """One adamw step of the smoke config on a ('data', 'model') mesh of
    ``mesh_shape``: the whole parameters, moments and metrics after it."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = _train_cfg()
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device="cpu")
    kw = dict(checkpoint_dir=str(ckpt_dir), checkpoint_every=100) \
        if ckpt_dir else {}
    trainer = Trainer(cfg, TrainConfig(**TRAIN, **kw), device="cpu",
                      mesh=mesh)
    model, state, hist = trainer.run(model=_model(cfg), resume=False)
    whole = lambda t: t.full_tensor()  # noqa: E731
    return {"hist": hist, "n_dp": trainer.n_dp,
            "params": {k: whole(p) for k, p in trainer.params.items()},
            "model_empty": _empty(model),
            "model": _gathered(trainer, model),
            "m": {k: whole(t) for k, t in state["m"].items()},
            "v": {k: whole(t) for k, t in state["v"].items()},
            "local_shapes": {k: tuple(p.to_local().shape)
                             for k, p in trainer.params.items()},
            "placements": {k: [str(x) for x in p.placements]
                           for k, p in trainer.params.items()}}


def job_train(rank, world, tmp):
    """One step on a (2, 1) mesh, saving a checkpoint; one step on (1, 2);
    then the checkpoint restored onto (1, 2)."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer
    ck = tmp / "ckpt"
    out = {"2x1": _train((2, 1), ck), "1x2": _train((1, 2)),
           "ckpt_dir": str(ck)}
    cfg = _train_cfg()
    mesh = make_host_mesh(model=2, data=1, device="cpu")
    trainer = Trainer(cfg, TrainConfig(**TRAIN, checkpoint_dir=str(ck)),
                      device="cpu", mesh=mesh)
    model, state, start = trainer.init_state(resume=True, model=_model(cfg))
    tree = (trainer.params, state)
    out["restore"] = {
        "start": start,
        "whole": {k: t.full_tensor() for k, t in _flatten(tree)},
        "placements": {k: [str(x) for x in t.placements]
                       for k, t in _flatten(tree)},
        "model_empty": _empty(model),
        "model": _gathered(trainer, model)}
    return out


def _grads(rank):
    g = torch.Generator().manual_seed(100 + rank)
    return {"w": torch.randn(3, 300, generator=g) * (rank + 1),
            "b": torch.randn(7, generator=g)}


def job_psum(rank, world, tmp):
    from repro_torch.training.grad_compress import (compress_int8,
                                                    init_residual,
                                                    psum_compressed)
    grads = _grads(rank)
    res = init_residual(grads)
    out = {"grads": grads, "q": compress_int8(grads, res)[0]}
    for method in ("int8", "topk", "none"):
        out[method] = psum_compressed(grads, res, None, method=method)
    return out


def _fitness_case(policy, objectives, genomes):
    from repro_torch.cluster.spec import paper_testbed
    from repro_torch.core.fitness import (EvalConfig, TraceEvaluator,
                                          population_mesh)
    from repro_torch.workload.slo import attach_slos
    from repro_torch.workload.trace import build_trace
    tr = build_trace(40, seed=0)
    attach_slos(tr, seed=0)
    ev = TraceEvaluator(tr, paper_testbed(), EvalConfig(concurrency=4),
                        bucket="pow2", device="cpu")
    mesh = population_mesh(device="cpu")
    g = torch.tensor(genomes, dtype=torch.float32)
    plain = ev.make_fitness(policy, objectives=objectives)(g)
    sharded = ev.make_fitness(policy, objectives=objectives, mesh=mesh)(g)
    return ev, mesh, plain, sharded


SLO_GENOMES = [[0.9, 3.0], [0.5, 1.0], [1.0, 10.0]]
THRESHOLD_GENOMES = [[0.5, 0.5, 0.5, 5.0, 0.7, 0.7],
                     [0.2, 0.8, 0.4, 2.0, 0.5, 0.9],
                     [0.9, 0.1, 0.6, 12.0, 0.35, 0.4]]


def job_fitness(rank, world, tmp):
    """The 3-genome population under slo / qoe and threshold / paper,
    sharded and not; then 4 NSGA-II generations under the sharded fitness
    from one seed on every rank."""
    from repro_torch.core.nsga2 import NSGA2, NSGA2Config
    out = {}
    for policy, objectives, genomes in (("slo", "qoe", SLO_GENOMES),
                                        ("threshold", "paper",
                                         THRESHOLD_GENOMES)):
        ev, mesh, plain, sharded = _fitness_case(policy, objectives, genomes)
        out[policy] = {"plain": plain, "sharded": sharded}
    fit = ev.make_fitness("threshold", objectives="paper", mesh=mesh)
    opt = NSGA2(fit, NSGA2Config.from_policy("threshold", pop_size=6,
                                             n_generations=4), device="cpu")
    state = opt.evolve(torch.Generator().manual_seed(0))
    out["nsga2"] = {f: getattr(state, f) for f in state._fields}
    return out


def main(job, rank, world, rdv, out):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = globals()[f"job_{job}"](rank, world, Path(out))
        torch.save(res, Path(out) / f"{job}_{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    main(*sys.argv[1:])
