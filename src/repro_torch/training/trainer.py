"""The training loop: the counterpart of ``repro.training.trainer``.

It composes the model zoo (``lm.loss_fn``, each period of the block pattern
checkpointed), the memory-tiered optimizers, gradient accumulation over
microbatches, the deterministic data pipeline and checkpoint/restart: the
trainer resumes from the latest committed step. On the card every
self-attention layer runs the flash kernel forward and, in the backward,
its backward kernels (``kernels.flash_attention.FlashAttention``).

Parameters come from ``lm.init`` with a ``torch.Generator`` seeded by
``TrainConfig.seed`` on the training device, or from a model the caller
hands in (the tests hand in the reference's initial parameters).

**On a mesh** (``Trainer(mesh=)``, a ``DeviceMesh`` with the reference's
('data', 'model') or ('pod', 'data', 'model') axes over every rank of an
initialized process group): parameters and optimizer state are stored as
DTensors with the placements of ``sharding.param_specs(mode="train")`` and
``dryrun.opt_state_specs`` (``self.params``, the optimizer state), each
rank holding its blocks. The model's own parameters hold no storage
between steps. A step fills them FSDP-style: the embedding, head, final
norm and encoder for the whole step, and each period of the block pattern
just before it runs, again before its recompute in the backward, and frees
it when the next one is filled (with ``remat``; without it every period
stays filled to the step's end). The weights of the 'model'-parallel
regions (``sharding.model_split``: the vocab-parallel embedding and head,
the column- / row-parallel FFN, the experts, attention's query heads and
the KV heads they read, Mamba's channels) are filled over the other axes
only, so a rank holds and computes on its compute blocks of them
(``models.tensor_parallel``, whose ``Region`` the step sets on those
modules; blocks that storage cuts elsewhere are moved by an all-to-all),
and the hand-written flash kernels run on each rank's local heads; the
rest (xLSTM, attention with fewer heads than the axis, norms, routers) is
filled whole. Each data-parallel rank (the coordinate over
the DP axes) trains on its rows of the global batch
(``SyntheticLMData(host_index=, n_hosts=)``), the DP axes those of the
reference's input specs (the whole mesh for ``tp_friendly=False`` archs,
which then have no region). As each parameter's gradient is complete it
is summed over the DP axes' process groups in f32, divided by their
count, moved back to storage's blocks (a KV head's gradient summed over
the ranks that read it; qk-norm's gains, filled whole but acting on the
rank's heads, summed over 'model'), and only this rank's block of it is
kept. The global gradient norm
is summed from the blocks. Every optimizer then updates this rank's
blocks in place (``optim``'s ``layouts``: its reductions over split axes
run as collectives), so no rank ever holds a whole expert stack,
vocabulary table or optimizer leaf. Checkpoints record the specs and
restore onto the current mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .._device import Device, resolve
from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLMData
from ..models import lm
from ..models import sharding as shard
from ..models import tensor_parallel as TP
from ..models.config import ModelConfig
from .optim import OptConfig, make_optimizer, optimizer_for_arch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1          # gradient accumulation steps
    steps: int = 100
    optimizer: Optional[str] = None  # default: by model size
    opt: OptConfig = OptConfig()
    remat: bool = True
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_checkpoints: int = 2
    log_every: int = 10
    seed: int = 0
    # synthetic-corpus difficulty (tests/examples use an easy setting so the
    # loss visibly decreases within ~100 CPU steps)
    data_vocab: Optional[int] = None   # tokens drawn from [0, data_vocab)
    data_chains: int = 8
    data_branch: int = 32


def _nbytes(tree) -> int:
    """Bytes of the tensors of a dict tree."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.nbytes


def _local(tree):
    """A dict tree of DTensors as this rank's blocks (views: writing them
    writes the DTensors)."""
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree.to_local()


class Trainer(shard.MeshParams):
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 device: Device = None, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve(device)
        #: the mesh axes the batch splits over (the reference's input
        #: specs: the whole mesh for tp_friendly=False archs, each axis
        #: kept while the global batch divides)
        self.dp: tuple = ()
        self.n_dp, dp_index = 1, 0
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh on {mesh.device_type}, trainer on "
                                 f"{self.device}")
            self.dp = shard.best_dp_prefix(
                mesh, tcfg.global_batch, full_dp=not cfg.tp_friendly) or ()
            dp_index, self.n_dp = shard.dp_coordinate(mesh, self.dp)
        local = tcfg.global_batch // self.n_dp
        if local % tcfg.microbatches:
            raise ValueError(f"global_batch {tcfg.global_batch} does not "
                             f"split into {self.n_dp} data-parallel ranks "
                             f"of {tcfg.microbatches} microbatches")
        self.opt_name = tcfg.optimizer or optimizer_for_arch(
            cfg.param_counts()["total"])
        stacks = functools.partial(lm.param_stacks, cfg)
        self.opt = make_optimizer(self.opt_name, tcfg.opt, stacks)
        self.data = SyntheticLMData(DataConfig(
            vocab=min(tcfg.data_vocab or cfg.vocab, cfg.vocab),
            seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
            seed=tcfg.seed, n_chains=tcfg.data_chains,
            branch=tcfg.data_branch), host_index=dp_index, n_hosts=self.n_dp)
        # on a mesh, ``peak_bytes`` holds the most bytes a step has held
        # at once of: parameters filled into the model ("filled": whole,
        # or their 'model' blocks in a region), parameters, gradients and
        # state that the update gathers whole ("update": none, every
        # optimizer updates the blocks in place), and the f32 gradient
        # blocks kept from the backward to the update ("grads"); a region
        # exists for tp_friendly archs, whose batch never splits over
        # 'model'
        super().__init__(cfg, mesh, "train", ("filled", "update", "grads"))
        self.sspecs = None
        #: on a mesh, each parameter's ``sharding.BlockLayout``
        self.layouts: Optional[Dict[str, shard.BlockLayout]] = None
        if mesh is not None:
            from ..launch.dryrun import opt_state_specs
            self.sspecs = opt_state_specs(self.opt_name, self.shapes,
                                          self.pspecs, stacks)
            self.layouts = {k: shard.block_layout(mesh, self.pspecs[k], shp)
                            for k, shp in self.shapes.items()}
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       keep=tcfg.keep_checkpoints,
                                       save_interval_steps=tcfg.checkpoint_every)
                     if tcfg.checkpoint_dir else None)

    # ------------------------------------------------------------------
    def _grads(self, model: lm.LM, params, batch):
        """(loss, nll, gradients in the parameters' dtype) of one batch."""
        loss, aux = lm.loss_fn(model, self.cfg, batch, remat=self.tcfg.remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), aux["nll"].detach(), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}

    def train_step(self, model: lm.LM, opt_state, batch):
        """One optimizer step on ``batch`` (tokens and labels (B, S): this
        rank's rows on a mesh); updates the parameters (the model's, or
        the stored blocks on a mesh) and ``opt_state`` in place and
        returns (opt_state, metrics: loss, nll, gnorm as 0-d tensors).

        With microbatches, the gradients of each 1/microbatches slice of
        the batch (rows in order) are summed into f32 zeros and divided by
        the count, and loss and nll are the slices' means, as the
        reference's scan does."""
        if self.mesh is not None:
            return self._mesh_step(model, opt_state, batch)
        params = dict(model.named_parameters())
        n = self.tcfg.microbatches
        if n == 1:
            loss, nll, grads = self._grads(model, params, batch)
        else:
            mb = batch["tokens"].shape[0] // n
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            losses, nlls = [], []
            for i in range(n):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, nll_i, g = self._grads(model, params, part)
                for k, gi in g.items():
                    grads[k].add_(gi.to(torch.float32))
                del g
                losses.append(l_i)
                nlls.append(nll_i)
            for g in grads.values():
                g.div_(n)
            loss, nll = torch.stack(losses).mean(), torch.stack(nlls).mean()
        _, opt_state = self.opt.update(grads, opt_state, params)
        return opt_state, {"loss": loss, "nll": nll,
                           "gnorm": opt_state["gnorm"]}

    # ------------------------------------------------------------------
    # on a mesh (storage and fills: ``sharding.MeshParams``; between steps
    # the model's parameters are empty, ``gather_model`` fills them whole)
    def _reduce_grad(self, grads, k: str, p: torch.Tensor) -> None:
        """Hook run when ``p``'s gradient is complete: the gradient
        averaged over the data-parallel ranks, moved from its compute
        block to storage's (``tensor_parallel.storage_grad``: ranges that
        ranks share summed over 'model'; a weight filled whole in a region
        holds each rank's partial sum, summed over 'model' too), this
        rank's block of it added to ``grads[k]`` (f32), the filled one
        dropped."""
        from torch.distributed.tensor import DTensor
        g = self._dp_mean(p.grad)
        placements, sp = shard.fill_placements(self.mesh), self.splits.get(k)
        if sp is not None and sp.dim is None:   # partial sums: the rank's
            TP.all_reduce(g, (self.region.group,))   # heads' share
        elif sp is not None:
            placements, src = self._storage(k)
            g = TP.storage_grad(g, src, sp, self.region, self.params[k].shape)
        block = DTensor.from_local(
            g, self.mesh, placements, run_check=False).redistribute(
                self.mesh, self.params[k].placements).to_local()
        p.grad = None
        if k in grads:
            grads[k].add_(block)
        else:
            grads[k] = block.clone()

    def _gnorm(self, grads) -> torch.Tensor:
        """The global norm of the gradients whose blocks are ``grads``:
        each block's sum of squares counted by the ranks at coordinate 0
        of the mesh dimensions it is replicated over, summed over the mesh,
        then over the parameters in order as ``optim`` sums them."""
        from torch.distributed.tensor import Replicate
        coord = self.mesh.get_coordinate()
        sq = torch.stack([
            torch.sum(torch.square(g))
            if all(c == 0 for c, pl in zip(coord, self.params[k].placements)
                   if isinstance(pl, Replicate))
            else torch.zeros((), dtype=torch.float32, device=g.device)
            for k, g in grads.items()])
        for i in range(self.mesh.ndim):
            dist.all_reduce(sq, group=self.mesh.get_group(i))
        return torch.sqrt(sum(sq.unbind()))

    def _mesh_step(self, model: lm.LM, opt_state, batch):
        """``train_step`` on the mesh (the module's docstring)."""
        params = dict(model.named_parameters())
        # each period filled before it runs; with remat, the period filled
        # before it freed (its forward, or its backward, is done)
        materialize = self._period_filler(model, params,
                                          free_previous=self.tcfg.remat)
        grads: Dict[str, torch.Tensor] = {}
        hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(self._reduce_grad, grads, k))
            for k, p in params.items()]
        n = self.tcfg.microbatches
        mb = batch["tokens"].shape[0] // n
        losses, nlls = [], []
        with self._regions(model):
            try:
                self._fill(params, [k for k in params
                                    if not k.startswith("blocks.")])
                for i in range(n):
                    part = {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()}
                    loss, aux = lm.loss_fn(model, self.cfg, part,
                                           remat=self.tcfg.remat,
                                           materialize=materialize)
                    loss.backward()
                    losses.append(loss.detach())
                    nlls.append(aux["nll"].detach())
                    del loss, aux
            finally:
                for h in hooks:
                    h.remove()
                self._release(params, params)
        grads = {k: (grads[k].div_(n) if n > 1 else grads[k]) if k in grads
                 else torch.zeros(self.params[k].to_local().shape,
                                  dtype=torch.float32, device=self.device)
                 for k in params}
        loss = losses[0] if n == 1 else torch.stack(losses).mean()
        nll = nlls[0] if n == 1 else torch.stack(nlls).mean()
        loss, nll = self._dp_mean(loss), self._dp_mean(nll)
        gnorm = self._gnorm(grads)
        self._peak("grads", _nbytes(grads))
        scalars = {t: v.full_tensor() for t, v in opt_state.items()
                   if not isinstance(v, dict)}
        state = {t: v for t, v in opt_state.items() if isinstance(v, dict)}
        # each rank updates its blocks of the parameters and the state in
        # place; the optimizer's reductions over split axes are collectives
        _, new = self.opt.update(grads, {**_local(state), **scalars},
                                 _local(self.params), gnorm=gnorm,
                                 layouts=self.layouts)
        for t in scalars:
            state[t] = shard.shard(new[t], self.mesh, self.sspecs[t])
        return state, {"loss": loss, "nll": nll, "gnorm": new["gnorm"]}

    def _dp_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` (in f32) over the data-parallel ranks: summed
        over each DP axis's process group, divided by their count."""
        t = t.to(torch.float32).clone()
        for a in self.dp:
            dist.all_reduce(t, group=self.mesh.get_group(a))
        return t / self.n_dp

    # ------------------------------------------------------------------
    def init_state(self, resume: bool = True,
                   model: Optional[lm.LM] = None):
        """(model with gradients on, optimizer state, first step): ``model``
        or ``lm.init`` from the seed, then the latest committed checkpoint
        when ``resume``. On a mesh the parameters are stored as blocks
        (``self.params``) and the model's are left empty
        (``gather_model`` fills them)."""
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
            model = lm.init(self.cfg, gen, self.device)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if self.mesh is None:
            opt_state = self.opt.init(params)
        else:
            self._store(model)
            opt_state = shard.from_local_tree(
                self.opt.init(_local(self.params), self.layouts),
                self.sspecs, self.mesh)
        start = 0
        if self.ckpt and resume and self.ckpt.latest_step() is not None:
            if self.mesh is None:
                (saved, opt_state), manifest = self.ckpt.restore(
                    (params, opt_state))
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(saved[k])
            else:
                (self.params, opt_state), manifest = self.ckpt.restore(
                    (self.params, opt_state), mesh=self.mesh,
                    specs=(self.pspecs, self.sspecs))
            start = manifest["step"]
        return model, opt_state, start

    def _saved(self, model: lm.LM, opt_state):
        """(tree, specs) that a checkpoint stores: the stored parameters
        and their specs on a mesh, else the model's parameters."""
        if self.mesh is None:
            return (dict(model.named_parameters()), opt_state), None
        return (self.params, opt_state), (self.pspecs, self.sspecs)

    def batch(self, host: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, torch.int64)
                for k, v in host.items()}

    def run(self, steps: Optional[int] = None, resume: bool = True,
            callback: Optional[Callable[[int, Dict], None]] = None,
            model: Optional[lm.LM] = None):
        """Train to step ``steps`` (default ``TrainConfig.steps``) from step
        0 or the latest checkpoint; returns (model, optimizer state,
        history: the metrics of every ``log_every``-th step and the last,
        with ``step`` and ``tokens_per_s``). On a mesh the model comes back
        with its parameters empty, as between steps (``gather_model``).

        The checkpoint of step N holds the state after N updates, and a run
        resumed from it starts with batch N: every ``checkpoint_every``
        updates and at the end. (The reference labels a save inside the
        loop with the step just taken, N + 1 updates in, so a run resumed
        from one trains that batch twice.) A step already committed is
        never written again."""
        steps = steps or self.tcfg.steps
        model, opt_state, start = self.init_state(resume=resume, model=model)
        history = []
        it = self.data.iterator(start_step=start)
        t0 = time.time()
        for step in range(start, steps):
            opt_state, metrics = self.train_step(model, opt_state,
                                                 self.batch(next(it)))
            if step % self.tcfg.log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["tokens_per_s"] = (self.tcfg.global_batch
                                     * self.tcfg.seq_len
                                     * (step - start + 1)
                                     / (time.time() - t0))
                history.append(m)
                if callback:
                    callback(step, m)
            done = step + 1
            if self.ckpt and done < steps and self.ckpt.should_save(done):
                tree, specs = self._saved(model, opt_state)
                self.ckpt.save(done, tree, specs=specs,
                               metadata={"arch": self.cfg.name})
        if self.ckpt:
            if steps > start:
                tree, specs = self._saved(model, opt_state)
                self.ckpt.save(steps, tree, specs=specs,
                               metadata={"arch": self.cfg.name},
                               blocking=True)
            self.ckpt.wait()
            if self.mesh is not None:   # rank 0's commit, seen by all
                dist.barrier()
        return model, opt_state, history
