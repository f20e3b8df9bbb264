"""The training loop: the counterpart of ``repro.training.trainer`` on one
device.

It composes the model zoo (``lm.loss_fn``, each period of the block pattern
checkpointed), the memory-tiered optimizers, gradient accumulation over
microbatches, the deterministic data pipeline and checkpoint/restart: the
trainer resumes from the latest committed step. On the card every
self-attention layer runs the flash kernel forward and, in the backward,
its backward kernels (``kernels.flash_attention.FlashAttention``).

Parameters come from ``lm.init`` with a ``torch.Generator`` seeded by
``TrainConfig.seed`` on the training device, or from a model the caller
hands in (the tests hand in the reference's initial parameters). A mesh
(the reference's FSDP x TP x DP sharding) belongs to the multi-device part
of the port and raises.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional

import torch

from .._device import Device, resolve
from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLMData
from ..models import lm
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


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 device: Device = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("Trainer(mesh=): the sharded trainer "
                                      "is not ported")
        if tcfg.global_batch % tcfg.microbatches:
            raise ValueError(f"global_batch {tcfg.global_batch} is not a "
                             f"multiple of microbatches {tcfg.microbatches}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve(device)
        self.opt_name = tcfg.optimizer or optimizer_for_arch(
            cfg.param_counts()["total"])
        self.opt = make_optimizer(self.opt_name, tcfg.opt,
                                  functools.partial(lm.param_stacks, cfg))
        self.data = SyntheticLMData(DataConfig(
            vocab=min(tcfg.data_vocab or cfg.vocab, cfg.vocab),
            seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
            seed=tcfg.seed, n_chains=tcfg.data_chains,
            branch=tcfg.data_branch))
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
        """One optimizer step on ``batch`` (tokens and labels (B, S));
        updates the model's parameters and ``opt_state`` in place and
        returns (opt_state, metrics: loss, nll, gnorm as 0-d tensors).

        With microbatches, the gradients of each 1/microbatches slice of
        the batch (rows in order) are summed into f32 zeros and divided by
        the count, and loss and nll are the slices' means, as the
        reference's scan does."""
        params = dict(model.named_parameters())
        n = self.tcfg.microbatches
        if n == 1:
            loss, nll, grads = self._grads(model, params, batch)
        else:
            mb = self.tcfg.global_batch // n
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
    def init_state(self, resume: bool = True,
                   model: Optional[lm.LM] = None):
        """(model with gradients on, optimizer state, first step): ``model``
        or ``lm.init`` from the seed, then the latest committed checkpoint
        when ``resume``."""
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
            model = lm.init(self.cfg, gen, self.device)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        opt_state = self.opt.init(params)
        start = 0
        if self.ckpt and resume and self.ckpt.latest_step() is not None:
            (saved, opt_state), manifest = self.ckpt.restore(
                (params, opt_state))
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])
            start = manifest["step"]
        return model, opt_state, start

    def batch(self, host: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, torch.int64)
                for k, v in host.items()}

    def run(self, steps: Optional[int] = None, resume: bool = True,
            callback: Optional[Callable[[int, Dict], None]] = None,
            model: Optional[lm.LM] = None):
        """Train to step ``steps`` (default ``TrainConfig.steps``) from step
        0 or the latest checkpoint; returns (model, optimizer state,
        history: the metrics of every ``log_every``-th step and the last,
        with ``step`` and ``tokens_per_s``).

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
                self.ckpt.save(done, (dict(model.named_parameters()),
                                      opt_state),
                               metadata={"arch": self.cfg.name})
        if self.ckpt:
            if steps > start:
                self.ckpt.save(steps, (dict(model.named_parameters()),
                                       opt_state),
                               metadata={"arch": self.cfg.name},
                               blocking=True)
            self.ckpt.wait()
        return model, opt_state, history
