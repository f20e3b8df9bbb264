"""Train a reduced-config model for a few hundred steps with the full
stack: AdamW, microbatching, the deterministic data pipeline, periodic
checkpoints, and a simulated crash and resume halfway through. The
counterpart of ``examples/train_small.py``.

    PYTHONPATH=src python -m repro_torch.train_small [--device cpu]
        [--arch stablelm-3b] [--steps 200]

It runs on CUDA unless ``--device cpu`` is given; the checkpoints go to a
temporary directory that is removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

from ._device import resolve
from .configs import get
from .training.optim import OptConfig
from .training.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    ckdir = Path(tempfile.mkdtemp()) / "ck"
    cfg = get(args.arch).smoke()
    print(f"training {cfg.name}: "
          f"{cfg.param_counts()['total'] / 1e6:.1f}M params on {dev}")
    common = dict(seq_len=128, global_batch=8, microbatches=2,
                  checkpoint_dir=str(ckdir), checkpoint_every=50,
                  log_every=20, data_vocab=64, data_chains=2, data_branch=4,
                  opt=OptConfig(lr=3e-3))
    try:
        half = args.steps // 2
        print(f"\n-- phase 1: steps 0..{half}, then simulated crash --")
        Trainer(cfg, TrainConfig(steps=half, **common), device=dev).run(
            resume=False,
            callback=lambda s, m: print(f"  step {s:4d} nll {m['nll']:.4f} "
                                        f"tok/s {m['tokens_per_s']:.0f}"))

        print(f"\n-- phase 2: restart from checkpoint, steps {half}.."
              f"{args.steps} --")
        t = Trainer(cfg, TrainConfig(steps=args.steps, **common), device=dev)
        print(f"  resuming from step {t.ckpt.latest_step()}")
        _, _, hist = t.run(
            resume=True,
            callback=lambda s, m: print(f"  step {s:4d} nll {m['nll']:.4f} "
                                        f"tok/s {m['tokens_per_s']:.0f}"))
        print(f"\nfinal nll: {hist[-1]['nll']:.4f} (started "
              f"~{hist[0]['nll']:.2f} — loss decreases on the Markov-mixture "
              f"corpus)")
    finally:
        shutil.rmtree(ckdir.parent, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
