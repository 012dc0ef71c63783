"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``, with its flags: on one device
(the card by default, ``--device cpu`` for the plain PyTorch run) or over
a (data, model) mesh under training's rules (``sharding/rules.py:
make_rules``).  ``--mesh DP,TP`` spawns DP x TP ranks here, their
collectives over ``--backend`` (gloo runs anywhere, several ranks on one
card included; nccl needs a card per rank), as ``launch/serve.py --mesh``
does; ``--mesh production`` trains over the reference's (16, 16)
production mesh in a world that is already initialized (a ``torchrun``
launch of 256 ranks).  The reduced config (``--reduced``, the default)
trains on a CPU; ``--full`` takes the registry's published widths.  Mesh
training takes every arch: attention and MLA blocks split their heads,
dense FFNs their hidden units and MoE FFNs their experts (EP or
expert-TP, as the rules place them), and SSM and RG-LRU blocks read their
weights whole (``train/train_step.py``).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import DataConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def _parse(argv):
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
    ap.add_argument("--mesh", default="none",
                    help="none (one device), production (the (16, 16) mesh "
                         "of an initialized 256-rank world) or DP,TP "
                         "(spawn DP x TP ranks here)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo",
                    help="the spawned ranks' collectives (--mesh DP,TP)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "int8_ef"],
                    default="none")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    return ap.parse_args(argv)


def _trainer(args, device, mesh=None) -> Trainer:
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    rules = None
    if mesh is not None:
        from repro_torch.sharding.rules import make_rules
        rules = make_rules(mesh, n_routed=cfg.n_routed)
    run = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    return Trainer(cfg, tcfg, run, data_cfg=data, device=device, rules=rules)


def _rank_train(mesh, device, args) -> dict:
    """A spawned rank: its Trainer over the mesh."""
    tr = _trainer(args, device, mesh)
    tr.train()
    return {"coord": tuple(mesh.get_coordinate()),
            "metrics": tr.metrics_log}


def main(argv=None):
    args = _parse(argv)
    device = resolve_device(args.device)
    if args.mesh == "none":
        trainer = _trainer(args, device)
        trainer.train()
        print(f"[train] done: {args.steps} steps of {trainer.cfg.name} on "
              f"{device}")
        return trainer
    import torch.distributed as dist
    if args.mesh == "production":
        if not dist.is_initialized():
            raise ValueError(
                "--mesh production is mesh training over an initialized "
                "256-rank world (a torchrun launch), and no process group "
                "is initialized; --mesh DP,TP spawns its ranks here")
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh()
        if device.type == "cuda":
            import torch
            device = torch.device("cuda", dist.get_rank()
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        trainer = _trainer(args, device, mesh)
        trainer.train()
        print(f"[train] done: {args.steps} steps of {trainer.cfg.name} on "
              f"the production mesh, rank {dist.get_rank()}")
        return trainer
    try:
        data, model = (int(n) for n in args.mesh.split(","))
    except ValueError:
        raise ValueError(f"--mesh must be none, production or DP,TP; got "
                         f"{args.mesh!r}") from None
    from repro_torch.launch.mesh import spawn_mesh
    ranks = spawn_mesh(_rank_train, data, model, device=device.type,
                       backend=args.backend, args=(args,),
                       timeout=24 * 3600.0)
    losses = [[m["loss"] for m in r["metrics"]] for r in ranks]
    print(f"[train] rank 0 {ranks[0]['coord']}: loss "
          f"{[round(x, 4) for x in losses[0]]}, grad norm "
          f"{[round(m['grad_norm'], 4) for m in ranks[0]['metrics']]}")
    print(f"[train] the same loss on every rank: "
          f"{all(x == losses[0] for x in losses)}")
    print(f"[train] done: {args.steps} steps of {args.arch} on a "
          f"{data}x{model} mesh of {device.type} ranks ({args.backend})")
    return ranks


if __name__ == "__main__":
    main()
