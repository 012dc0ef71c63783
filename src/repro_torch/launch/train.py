"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``, with its flags, on one device:
the card by default, ``--device cpu`` for the plain PyTorch run.  The
reduced config (``--reduced``, the default) trains on a CPU; ``--full``
takes the registry's published widths.  ``--mesh production`` is mesh
training, the next slice of the port: it is refused, not quietly run on one
device.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import DataConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=TrainerConfig.ckpt_dir,
                    help="default: $TMPDIR/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["none", "production"], default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "int8_ef"],
                    default="none")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    if args.mesh == "production":
        raise ValueError(
            "--mesh production is mesh training, the next slice of the port "
            "(ROADMAP A10); this launcher trains on one device only")
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    run = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    trainer = Trainer(cfg, tcfg, run, data_cfg=data, device=device)
    trainer.train()
    print(f"[train] done: {args.steps} steps of {cfg.name} on {device}")
    return trainer


if __name__ == "__main__":
    main()
