"""Training launcher: the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        [--device cpu] [--smoke] [--steps 50] [--checkpoint-dir DIR]

``--smoke`` trains the reduced config; without it the published widths
(on the card). It runs on CUDA unless ``--device cpu`` is given. Training
resumes from the latest committed checkpoint in ``--checkpoint-dir``
unless ``--no-resume``. ``run_train`` is the body, which ``chip_smoke.py``
calls. The reference's ``--dry-run`` (the sharded step on a production
mesh) is ``python -m repro_torch.launch.dryrun``; ``Trainer(mesh=)`` is
the sharded trainer.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

from .._device import Device, resolve
from ..configs import all_ids, get
from ..models.config import ModelConfig
from ..training.optim import OptConfig
from ..training.trainer import TrainConfig, Trainer


def run_train(arch: str, smoke: bool = False, device: Device = None,
              resume: bool = True,
              callback: Optional[Callable[[int, Dict], None]] = None,
              cfg: Optional[ModelConfig] = None, lr: float = 1e-3,
              **train: object) -> List[Dict]:
    """Train ``arch`` (its ``smoke()`` config with ``smoke``, else its
    published one; ``cfg`` replaces either) and return the history of
    logged steps (``Trainer.run``). ``train`` takes ``TrainConfig``'s
    fields (``steps``, ``seq_len``, ``global_batch``, ``microbatches``,
    ``optimizer``, ``checkpoint_dir``, ...); ``lr`` goes into its
    ``OptConfig``."""
    if cfg is None:
        mod = get(arch)
        cfg = mod.smoke() if smoke else mod.config()
    tcfg = TrainConfig(opt=OptConfig(lr=lr), **train)
    trainer = Trainer(cfg, tcfg, device=resolve(device))
    _, _, history = trainer.run(resume=resume, callback=callback)
    return history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=all_ids())
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default=None,
                    choices=[None, "adamw", "adamw8bit", "adafactor"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)

    mod = get(args.arch)
    cfg = mod.smoke() if args.smoke else mod.config()
    dev = resolve(args.device)
    print(f"arch={cfg.name} params={cfg.param_counts()['total'] / 1e6:.1f}M "
          f"device={dev}")
    hist = run_train(
        args.arch, cfg=cfg, device=dev, resume=not args.no_resume,
        lr=args.lr, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        optimizer=args.optimizer, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        callback=lambda step, m: print(
            f"step {step:5d} loss {m['loss']:.4f} nll {m['nll']:.4f} "
            f"gnorm {m['gnorm']:.3f} tok/s {m['tokens_per_s']:.0f}",
            flush=True))
    print("final:", hist[-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
