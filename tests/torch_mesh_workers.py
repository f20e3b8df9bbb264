"""Rank bodies of the port's multi-rank CPU runs (gloo), for
``tests/test_torch_mesh_train.py`` and ``tests/test_torch_mesh_serve.py``.
Nothing here imports JAX: each rank is
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
#: the MoE smoke configs trained on (1, 2): top-1 experts with a dense FFN
#: every other layer, and top-2 experts in every layer
MOE_ARCHS = ("llama4-maverick-400b-a17b", "dbrx-132b")
#: the smoke configs whose attention heads (and Mamba channels) split over
#: 'model' on (1, 2), at most two to a job: qk-norm (the run starts from
#: the reference's initial parameters, ``init_<arch>.pt`` beside the
#: output), one KV head both ranks read, Mamba with attention and experts,
#: cross-attention, and the bidirectional encoder with cross-attention
HEAD_JOBS = {"train_heads": ("qwen3-1.7b", "stablelm-12b"),
             "train_hybrid": ("jamba-v0.1-52b", "llama-3.2-vision-11b"),
             "train_whisper": ("whisper-tiny",)}
HEAD_ARCHS = tuple(a for archs in HEAD_JOBS.values() for a in archs)
#: the (1, 4) run: qwen3's smoke config at 6 query heads on 2 KV heads, so
#: that the ranks take 1, 2, 1 and 2 heads and two ranks read each KV head
#: (as llama4's 40 heads on 8 KV heads do on 16)
HEADS4 = ("qwen3-1.7b", dict(n_heads=6, n_kv_heads=2))


#: the sharded serve step's runs: rows, prompt length, cache depth and
#: greedy decode steps after the prefill. On (1, 2) each rank holds 12 of
#: the 24 positions: rank 1's block starts empty for every row, and the
#: decode steps write positions 8..15, across the blocks' edge at 12
SERVE = dict(rows=4, prompt=8, max_seq=24, steps=8)
#: the smoke configs served on (1, 2), two to a job: qk-norm (from the
#: reference's initial parameters, ``init_<arch>.pt`` beside the output)
#: with Mamba channels, attention and experts; top-2 experts with
#: cross-attention
SERVE_JOBS = {"serve_heads": ("qwen3-1.7b", "jamba-v0.1-52b"),
              "serve_cross": ("dbrx-132b", "llama-3.2-vision-11b")}
SERVE_ARCHS = tuple(a for archs in SERVE_JOBS.values() for a in archs)
#: the runs whose rows the 'model' ranks share, so that xLSTM's states
#: split over 'model' ({job: (mesh shape, rows, smoke configs)}): on (1,
#: 4) xlstm's C (2 heads) splits its value axis and m stays whole, and
#: whisper's attention (2 heads) is no region while its cross K/V split
#: their 64 frames; on (1, 2) C and m split their heads. xlstm starts
#: from the reference's initial parameters where ``init_<arch>.pt`` lies
#: beside the output
STATE_JOBS = {"serve_state4": ((1, 4), 2, ("xlstm-1.3b", "whisper-tiny")),
              "serve_state2": ((1, 2), 3, ("xlstm-1.3b",))}


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


def _train_cfg(arch=TRAIN_ARCH, **changes):
    from repro_torch.configs import get
    return dataclasses.replace(get(arch).smoke(), dtype="float32",
                               **changes)


def _model(cfg, seed=0):
    from repro_torch.models import lm
    return lm.init(cfg, torch.Generator().manual_seed(seed), "cpu")


def cross_inputs(cfg, rows):
    """The stub-frontend frames (audio) or patches (vision) of ``rows``
    rows, bf16 from a seed, that the trainer's token batches lack; nothing
    for the other families."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    audio = cfg.family == "audio"
    T = cfg.encoder.n_frames if audio else cfg.cross_kv_tokens
    x = torch.randn((rows, T, cfg.d_model),
                    generator=torch.Generator().manual_seed(11))
    return {"frames" if audio else "patches": x.to(torch.bfloat16)}


def with_cross(trainer):
    """``trainer``, each of whose steps also gets ``cross_inputs``."""
    step = trainer.train_step

    def train_step(model, state, batch):
        return step(model, state, {**batch, **cross_inputs(
            trainer.cfg, batch["tokens"].shape[0])})

    trainer.train_step = train_step
    return trainer


def _empty(model) -> bool:
    """Whether no parameter of ``model`` holds storage."""
    return all(p.untyped_storage().nbytes() == 0 for p in model.parameters())


def _gathered(trainer, model):
    """{name: whole parameter} of ``model`` filled from the stored
    blocks."""
    return {k: p.detach().clone()
            for k, p in trainer.gather_model(model).named_parameters()}


def _train(mesh_shape, ckpt_dir=None, arch=TRAIN_ARCH, cfg=None,
           init=None):
    """One adamw step of ``arch``'s smoke config (or ``cfg``) on a
    ('data', 'model') mesh of ``mesh_shape``, from ``_model`` (or the
    parameters saved in the file ``init``): the whole parameters, moments,
    gradients and metrics after it, the shapes each parameter was filled
    at during the step, and every MoE call's routing and drops."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, moe
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = cfg or _train_cfg(arch)
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device="cpu")
    kw = dict(checkpoint_dir=str(ckpt_dir), checkpoint_every=100) \
        if ckpt_dir else {}
    trainer = with_cross(Trainer(cfg, TrainConfig(**TRAIN, **kw),
                                 device="cpu", mesh=mesh))
    filled, grads, fill = {}, {}, trainer._fill
    update = trainer.opt.update

    def recording_fill(params, names, whole=False):
        fill(params, names, whole)
        for k in names:
            filled.setdefault(k, set()).add(tuple(params[k].shape))

    def recording_update(g, *args, **kw):
        grads.update({k: DTensor.from_local(
            t, mesh, trainer.params[k].placements,
            run_check=False).full_tensor() for k, t in g.items()})
        return update(g, *args, **kw)

    model = _model(cfg)
    if init is not None:
        model = lm.LM(cfg, "cpu")
        model.load_state_dict(torch.load(init))
    trainer._fill = recording_fill
    trainer.opt = trainer.opt._replace(update=recording_update)
    moe.ROUTING = []
    try:
        model, state, hist = trainer.run(model=model, resume=False)
        routing = moe.ROUTING
    finally:
        moe.ROUTING = None
        del trainer._fill, trainer.train_step
    whole = lambda t: t.full_tensor()  # noqa: E731
    return {"hist": hist, "n_dp": trainer.n_dp, "grads": grads,
            "params": {k: whole(p) for k, p in trainer.params.items()},
            "model_empty": _empty(model),
            "model": _gathered(trainer, model),
            "m": {k: whole(t) for k, t in state["m"].items()},
            "v": {k: whole(t) for k, t in state["v"].items()},
            "local_shapes": {k: tuple(p.to_local().shape)
                             for k, p in trainer.params.items()},
            "placements": {k: [str(x) for x in p.placements]
                           for k, p in trainer.params.items()},
            "filled_shapes": filled, "split": trainer.split,
            "routing": [(e, int(d)) for e, d in routing]}


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


def job_train_moe(rank, world, tmp):
    """One step of each MoE smoke config on (1, 2)."""
    return {arch: _train((1, 2), arch=arch) for arch in MOE_ARCHS}


def _head_job(job, tmp):
    """One step of each of ``HEAD_JOBS[job]``'s smoke configs on (1, 2)."""
    return {arch: _train((1, 2), arch=arch,
                         init=(tmp / f"init_{arch}.pt"
                               if (tmp / f"init_{arch}.pt").exists()
                               else None))
            for arch in HEAD_JOBS[job]}


def job_train_heads(rank, world, tmp):
    return _head_job("train_heads", tmp)


def job_train_hybrid(rank, world, tmp):
    return _head_job("train_hybrid", tmp)


def job_train_whisper(rank, world, tmp):
    return _head_job("train_whisper", tmp)


def job_train_heads4(rank, world, tmp):
    """One step of ``HEADS4``'s config on (1, 4): uneven query heads, KV
    heads read by two ranks, columns that storage cuts mid-head."""
    return _train((1, 4), cfg=_train_cfg(HEADS4[0], **HEADS4[1]))


def job_train4(rank, world, tmp):
    """One step of the llama4 smoke config on (2, 2): the regions' weights
    gathered over 'data' (a MoE's wi / wg moved over 'model' too) and the
    gradients averaged over it."""
    return _train((2, 2), arch=MOE_ARCHS[0])


def serve_inputs(cfg, rows=SERVE["rows"]):
    """The serve runs' prompt (rows, prompt) tokens, from a seed, and the
    rows' cross inputs."""
    g = torch.Generator().manual_seed(21)
    toks = torch.randint(0, cfg.vocab, (rows, SERVE["prompt"]),
                         generator=g)
    return toks, cross_inputs(cfg, rows)


def serve_greedy(prefill, decode, tokens, cross):
    """``prefill(tokens, cross)`` then SERVE["steps"] greedy
    ``decode(token (B, 1), cache)`` steps: (the logits of each, (steps +
    1, B, vocab); the tokens chosen (B, steps + 1); the last cache)."""
    logits, cache = prefill(tokens, cross)
    out, chosen = [logits], [logits.argmax(-1)]
    for _ in range(SERVE["steps"]):
        logits, cache = decode(chosen[-1][:, None], cache)
        out.append(logits)
        chosen.append(logits.argmax(-1))
    return torch.stack(out), torch.stack(chosen, 1), cache


def plain_serve(model, cfg, tokens, cross):
    """``serve_greedy`` through ``lm.prefill`` / ``lm.decode_step``."""
    from repro_torch.models import lm
    return serve_greedy(
        lambda t, c: lm.prefill(model, cfg, t, SERVE["max_seq"], **c),
        lambda t, cache: lm.decode_step(model, cfg, t, cache), tokens,
        cross)


def sharded_serve(server, tokens, cross):
    """``serve_greedy`` through ``server`` (a loaded ``ShardedServer``) on
    its rows of ``tokens`` and ``cross``."""
    return serve_greedy(
        lambda t, c: server.prefill(t, SERVE["max_seq"], None,
                                    c.get("frames"), c.get("patches")),
        server.decode_step, server.rows(tokens),
        {k: server.rows(x) for k, x in cross.items()})


def _serve(mesh_shape, arch, init=None, rows=SERVE["rows"]):
    """``sharded_serve`` of ``arch``'s f32 smoke config on a ('data',
    'model') mesh of ``mesh_shape``, from ``_model`` (or the parameters
    saved in ``init``), over ``rows`` rows: this rank's rows, logits,
    tokens and cache (its state leaves, each leaf's shape beside its
    ``cache_specs`` block's), the regions, what each fill filled and at
    which shapes, and the MoE calls' routing and drops."""
    from repro_torch.launch.dryrun import cache_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve_mesh import ShardedServer
    from repro_torch.models import lm, moe
    from repro_torch.models import sharding
    cfg = _train_cfg(arch)
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device="cpu")
    model = _model(cfg)
    if init is not None:
        model = lm.LM(cfg, "cpu")
        model.load_state_dict(torch.load(init))
    server = ShardedServer(cfg, mesh, "cpu")
    fills, fill = [], server._fill

    def recording_fill(params, names, whole=False):
        fill(params, names, whole)
        fills.append({k: tuple(params[k].shape) for k in names})

    server._fill = recording_fill
    server.load(model)
    tokens, cross = serve_inputs(cfg, rows)
    moe.ROUTING = []
    try:
        logits, chosen, cache = sharded_serve(server, tokens, cross)
        routing = moe.ROUTING
    finally:
        moe.ROUTING = None
    whole = lm.make_cache(cfg, rows, SERVE["max_seq"], "cpu")
    specs = sharding.cache_specs(cfg, whole, mesh)
    return {"rows": server.rows(torch.arange(rows)),
            "logits": logits, "tokens": chosen,
            "cache": {"k": tuple(cache.k.shape),
                      **{k: tuple(t.shape) for k, t in cache.state.items()}},
            "cache_kv": (cache.k, cache.v), "cache_max_seq": cache.max_seq,
            "cache_state": dict(cache.state),
            "spec_shapes": {
                k: sharding.local_shape(t.shape, mesh, spec)
                for k, t, spec in [("k", whole.k, specs.k)] + [
                    (k, t, specs.state[k]) for k, t in whole.state.items()]},
            "cache_specs": {"k": specs.k, **specs.state},
            "split_states": server.split_states,
            "cache_bytes": {
                "port": cache_bytes(cache),
                "spec": cache_bytes(whole, mesh, specs),
                "kv_spec": cache_bytes(whole._replace(state={}), mesh,
                                       specs._replace(state={}))},
            "split": server.split, "resident": server.resident,
            "stored": sorted(server.params), "fills": fills,
            "tp_cleared": all(getattr(m, "tp", None) is None
                              for m in model.modules()),
            "routing": [(e, int(d)) for e, d in routing]}


def _serve_job(job, tmp):
    """``_serve`` of each of ``SERVE_JOBS[job]``'s smoke configs on (1,
    2)."""
    return {arch: _serve((1, 2), arch,
                         init=(tmp / f"init_{arch}.pt"
                               if (tmp / f"init_{arch}.pt").exists()
                               else None))
            for arch in SERVE_JOBS[job]}


def job_serve_heads(rank, world, tmp):
    return _serve_job("serve_heads", tmp)


def job_serve_cross(rank, world, tmp):
    return _serve_job("serve_cross", tmp)


def _state_job(job, tmp):
    """``_serve`` of each of ``STATE_JOBS[job]``'s smoke configs."""
    mesh_shape, rows, archs = STATE_JOBS[job]
    return {arch: _serve(mesh_shape, arch, rows=rows,
                         init=(tmp / f"init_{arch}.pt"
                               if (tmp / f"init_{arch}.pt").exists()
                               else None))
            for arch in archs}


def job_serve_state4(rank, world, tmp):
    return _state_job("serve_state4", tmp)


def job_serve_state2(rank, world, tmp):
    return _state_job("serve_state2", tmp)


def job_serve4(rank, world, tmp):
    """The llama4 smoke config served on (2, 2) with ``BIG_MODEL_B`` at 0,
    so that its serve placements split over 'data' too and every step
    fills the weights a period at a time (gathered over 'data')."""
    from repro_torch.models import sharding
    sharding.BIG_MODEL_B = 0
    return _serve((2, 2), MOE_ARCHS[0])


#: the optimizer job's leaves on (1, 2): {name: (shape, spec)}. "w" and
#: "c" split their last axis so that a quantization block straddles the
#: two ranks (300 = 150 + 150 in blocks of 256, 64 = 32 + 32 in one
#: block); "r" splits rows (adafactor's column means and the mean of its
#: row factor span ranks), "e" experts, "g" a 1-D gain; "s0" and "s1"
#: stack into adafactor's one leaf, rows split
OPT_LEAVES = {"w": ((6, 300), (None, "model")),
              "e": ((4, 8, 96), ("model", None, None)),
              "r": ((64, 40), ("model", None)),
              "c": ((40, 64), (None, "model")),
              "g": ((40,), ("model",)),
              "s0": ((16, 48), ("model", None)),
              "s1": ((16, 48), ("model", None))}
OPT_STACKS = {"s0": ["s0", "s1"]}


def opt_stacks(names):
    return {k: v for k, v in OPT_STACKS.items() if set(v) <= set(names)}


def optim_case(name, seed=7):
    """numpy (params, grads, state) of the optimizer job for ``name``
    (adamw8bit or adafactor), the state in the port's structure (adafactor
    keyed by stack) some steps in; gradients kept under the clip."""
    import numpy as np
    from repro_torch.training.optim import QBLOCK
    rng = np.random.RandomState(seed)
    f32 = np.float32
    params = {k: rng.randn(*shp).astype(f32)
              for k, (shp, _) in OPT_LEAVES.items()}
    grads = {k: (1e-3 * rng.randn(*shp)).astype(f32)
             for k, (shp, _) in OPT_LEAVES.items()}
    if name == "adamw8bit":
        def q(shp):
            nb = -(-shp[-1] // min(QBLOCK, shp[-1]))
            return {"q": rng.randint(-127, 128, shp).astype(np.int8),
                    "s": (1e-4 * (0.5 + rng.rand(*shp[:-1], nb))).astype(f32)}
        state = {m: {k: q(shp) for k, (shp, _) in OPT_LEAVES.items()}
                 for m in ("m", "v")}
        for k, (shp, _) in OPT_LEAVES.items():   # v >= 0
            state["v"][k]["q"] = np.abs(state["v"][k]["q"])
        step = 2
    else:
        def fac(shp):
            pos = lambda s: (0.5 + rng.rand(*s)).astype(f32)  # noqa: E731
            if len(shp) >= 2:
                return {"vr": 1e-6 * pos(shp[:-1]),
                        "vc": 1e-6 * pos(shp[:-2] + shp[-1:])}
            return {"v": 1e-6 * pos(shp)}
        stacked = {n for v in OPT_STACKS.values() for n in v}
        state = {"f": {k: fac(shp) for k, (shp, _) in OPT_LEAVES.items()
                       if k not in stacked}}
        for key, members in OPT_STACKS.items():
            state["f"][key] = fac((len(members),) + OPT_LEAVES[key][0])
        step = 3
    state["step"] = np.asarray(step, np.int32)
    state["gnorm"] = np.asarray(0.0, f32)
    return params, grads, state


def job_optim(rank, world, tmp):
    """adamw8bit and adafactor updated once on (1, 2) from this rank's
    blocks of ``optim_case``'s arrays: the whole results (gathered) and
    the shapes of the blocks each rank updated."""
    import numpy as np
    from repro_torch.launch.dryrun import opt_state_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as shard
    from repro_torch.training.optim import (OptConfig, _tree_norm,
                                            make_optimizer)
    mesh = make_host_mesh(model=2, data=1, device="cpu")
    specs = {k: spec for k, (_, spec) in OPT_LEAVES.items()}
    shapes = {k: shp for k, (shp, _) in OPT_LEAVES.items()}
    layouts = {k: shard.block_layout(mesh, specs[k], shapes[k])
               for k in specs}

    def blocks(tree, sp):
        if isinstance(tree, dict):
            return {k: blocks(v, sp[k]) for k, v in tree.items()}
        return shard.local_block(tree, mesh, sp).clone()

    out = {}
    for name in ("adamw8bit", "adafactor"):
        params, grads, state = optim_case(name)
        sspecs = opt_state_specs(name, shapes, specs, opt_stacks)
        params, grads, state = map(_tree_torch, (params, grads, state))
        p, g, st = (blocks(params, specs), blocks(grads, specs),
                    blocks(state, sspecs))
        gnorm = _tree_norm(grads)
        opt = make_optimizer(name, OptConfig(lr=1e-2), opt_stacks)
        _, st = opt.update(g, st, p, gnorm=gnorm, layouts=layouts)
        whole = shard.from_local_tree({"params": p, "state": st},
                                      {"params": specs, "state": sspecs},
                                      mesh)
        out[name] = {"whole": _full(whole),
                     "local_shapes": {k: tuple(t.shape)
                                      for k, t in p.items()}}
    return out


def _tree_torch(tree):
    """A dict tree of numpy arrays as tensors (copies)."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: _tree_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor()


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
